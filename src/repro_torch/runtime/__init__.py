"""The runtime: training checkpoint / restart, elastic re-meshing, and
serve-side replica promotion and failure detection."""
from repro_torch.runtime.coordinator import (  # noqa: F401
    Coordinator, FailureDetector, LeaseConfig, RunConfig, StragglerPolicy,
    promote_on_primary_loss, promote_sharded, proven_cursor)
from repro_torch.runtime.elastic import ElasticPlan, plan_remesh  # noqa: F401
