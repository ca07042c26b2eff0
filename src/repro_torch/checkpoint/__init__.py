from repro_torch.checkpoint.checkpointer import (
    Checkpointer,
    latest_step,
    restore,
    save,
)

__all__ = ["Checkpointer", "latest_step", "restore", "save"]
