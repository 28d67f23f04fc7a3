from repro_torch.checkpoint.store import (
    latest_step,
    list_checkpoints,
    restore,
    save,
)

__all__ = ["latest_step", "list_checkpoints", "restore", "save"]
