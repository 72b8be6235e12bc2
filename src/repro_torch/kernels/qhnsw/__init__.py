from repro_torch.kernels.qhnsw.ops import (qhnsw_insert,  # noqa: F401
                                           qhnsw_search)
