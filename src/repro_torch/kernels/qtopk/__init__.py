from repro_torch.kernels.qtopk.ops import qtopk  # noqa: F401
