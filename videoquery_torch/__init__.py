"""videoquery_torch — the PyTorch/CUDA port of ``videoquery``.

It serves the broker round (``python -m videoquery_torch.service.broker``)
and extracts two-stream TSN features from video
(``python -m videoquery_torch.pipeline.extract``) on one NVIDIA GPU. The
similarity pass and the fused query scores run on a hand-written CUDA
kernel (``kernels/csrc/query_kernel.cu``), the TV-L1 flow on two more (one
pyramid level, ``kernels/csrc/tvl1_level.cu``; the window warp,
``kernels/csrc/window_warp.cu``); everything else is host code or plain
PyTorch. The JAX package ``videoquery`` is the reference this package is
tested against; this package never imports its jax modules, only the
jax-free fake API (in tests and smoke runs) and ``pipeline.decode`` and
``pipeline.sampling``.

Subpackages mirror ``videoquery``: ``core``, ``index``, ``kernels``, ``nn``,
``pipeline``, ``search``, ``service``. Their ``__init__`` files import
nothing, so any module can be imported alone.
"""

__version__ = "0.1.0"
