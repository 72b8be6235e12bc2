"""The optimizer and the integer gradient all-reduce."""
from repro_torch.optim.adamw import (AdamWConfig, adamw_init,  # noqa: F401
                                     adamw_update)
