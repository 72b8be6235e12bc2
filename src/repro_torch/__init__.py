"""PyTorch/CUDA port of the Valori deterministic memory substrate.

Imports ``torch`` and ``numpy`` only. Entry points run on ``cuda`` unless
the caller passes ``device="cpu"``; the CUDA kernels in ``kernels/`` build
from the sources in ``kernels/csrc`` at first use.
"""
