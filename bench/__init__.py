"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one H100.

Run a cell from the root of a checkout:

    python3 bench/run.py --workload CELL --seed N --seconds 51 --trace 0

``BENCHMARK.json`` names the cells. Each cell's configuration, traffic
mix and per-layer metrics, and the engine kinds, operations and data
kinds they name, are files here (``configs/``, ``traffic/``,
``metrics/``, ``engines/``, ``ops/``, ``data/``), found by name
(``harness``). ``reference/`` is the plain reference that decides
``correct``; ``tests/`` holds the CPU tests.
"""
