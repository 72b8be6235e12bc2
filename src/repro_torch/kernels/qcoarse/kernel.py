"""Launch of the hand-written qcoarse CUDA kernel (``csrc/qcoarse.cu``).

Replaces ``_qcoarse_kernel`` / ``qcoarse_planes_pallas`` of
``repro/kernels/qcoarse/kernel.py`` (the Pallas TPU kernel), together with
the int64 combine of ``repro/kernels/qcoarse/ops.py``: the TPU kernel
writes four int32 limb planes [nq, nn, 4] and XLA combines them outside;
this kernel keeps the same four int32 planes in registers and writes the
combined int64 scores, so the planes never reach device memory
(``ops.qcoarse_planes`` keeps them as a plain function for the parity
tests).

What bounds it on the card: bytes, by the count of the work. At the main
path's shape (64 queries x 131072 code rows x d = 2304) the function must
read 302.0 MB of int8 codes and 0.6 MB of weights and write 67.1 MB of
int64 scores: 369.7 MB, 0.110 ms at 3.35 TB/s, against 0.020 ms for its
1.9e10 multiply-adds at the int8 tensor-core rate (0.078 ms for the four
limb products this design issues for them).

What the design does about it (changed from the first port's CUDA-core
kernel, which issued 1.9e10 ``dp4a`` and ran at 17x its bound): the scan
runs on the int8 tensor cores (``wgmma`` m64n64k32, s8 x s8 for the top
limb and u8 x s8 for the three low bytes, s32 accumulation). The codes
are the B operand straight from device memory: 128-code stages of 128
rows stream through a 4-deep cp.async ring in shared memory, each code
byte read once per block of 64 weight rows, at a quarter of the int32
arena's bytes, the point of the tier. The weights are split once per call
by a small first kernel into byte planes already tiled in the tensor
cores' layout, so each stage's A operand is one contiguous 32 KB copy.
Four s32 planes per output (128 registers a thread in each of the two
warpgroups) combine into int64 at the store.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

PATHS = {0: "plain loads", 1: "cp.async"}


def path(codes: torch.Tensor) -> str:
    """The load path the kernel takes for these codes (``PATHS``)."""
    fn = _build.helper("qcoarse", "qcoarse_path",
                       [ctypes.c_void_p, ctypes.c_int64])
    return PATHS[fn(codes.data_ptr(), codes.shape[1])]


def scratch_bytes(nq: int, d: int) -> int:
    """Bytes of the weight-plane scratch one launch needs."""
    fn = _build.helper("qcoarse", "qcoarse_scratch_bytes",
                       [ctypes.c_int64, ctypes.c_int64], ctypes.c_int64)
    return fn(nq, d)


def launch(weights: torch.Tensor, codes: torch.Tensor, limbs: torch.Tensor,
           out: torch.Tensor) -> None:
    """weights int32 [nq, d], codes int8 [nn, d], limbs uint8 scratch of
    ``scratch_bytes(nq, d)``, out int64 [nq, nn]."""
    nq, d = weights.shape
    nn = codes.shape[0]
    fn = _build.launcher("qcoarse")
    err = fn(weights.data_ptr(), codes.data_ptr(), limbs.data_ptr(),
             out.data_ptr(), nq, nn, d,
             torch.cuda.current_stream(weights.device).cuda_stream)
    _build.check("qcoarse", err)
