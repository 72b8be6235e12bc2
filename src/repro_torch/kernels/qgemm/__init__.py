from repro_torch.kernels.qgemm.ops import qgemm, qgemm_planes  # noqa: F401
