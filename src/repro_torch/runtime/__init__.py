"""Serve-side runtime: replica promotion and failure detection."""
from repro_torch.runtime.coordinator import (  # noqa: F401
    FailureDetector, LeaseConfig, promote_on_primary_loss, promote_sharded,
    proven_cursor)
