"""The benchmark of ``videoquery_torch`` on one NVIDIA GPU.

One command runs one cell of ``BENCHMARK.json`` once, from the root of a
checkout::

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name: a cell's configuration in
``benchmark/configs/<config>.json``, its traffic mix in
``benchmark/traffic/<mix>.json`` (whose ``loop`` names the general
generator and loop in ``benchmark/loops/``), and each per-layer metric's
reader in ``benchmark/metrics/<metric>.py``. ``benchmark/reference/`` is
the plain PyTorch and NumPy reference that decides ``correct``; it imports
nothing of the program.
"""
