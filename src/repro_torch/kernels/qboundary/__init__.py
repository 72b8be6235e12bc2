from repro_torch.kernels.qboundary.ops import qboundary  # noqa: F401
