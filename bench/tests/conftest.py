"""The benchmark's CPU tests: the repository's root and ``src`` on the
path, and the ``cuda`` marker for tests that need the card (they decide
inside the test and skip on the CPU)."""
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU and nvcc (the port's CUDA "
        "kernels); skipped on the CPU")
