from repro_torch.kernels.qcoarse.ops import qcoarse, qcoarse_planes  # noqa: F401
