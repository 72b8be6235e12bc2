from repro_torch.checkpoint.manager import (  # noqa: F401
    CheckpointManager, DurableCheckpointManager, load_checkpoint,
    save_checkpoint)
