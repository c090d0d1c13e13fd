from repro_torch.ckpt.checkpoint import (CheckpointCorruptError,  # noqa: F401
                                         CheckpointError, CheckpointManager,
                                         PRNGKey, load_checkpoint,
                                         save_checkpoint)
