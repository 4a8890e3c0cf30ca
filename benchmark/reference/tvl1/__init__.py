"""The TV-L1 flow chain of the extraction reference: frozen copies of the
port's plain versions (``kernels/{tvl1,warp,resize,motion,window_warp,
tvl1_level,tvl1_flow}.py``, ``pipeline/{preprocess,sampling}.py``), with
every kernel replaced by its plain version. Each file names its origin."""
