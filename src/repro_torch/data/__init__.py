"""The deterministic training data pipeline."""
from repro_torch.data.pipeline import (DataConfig,  # noqa: F401
                                       DeterministicPipeline,
                                       feistel_permute)
