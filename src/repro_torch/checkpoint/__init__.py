"""Single-snapshot parameter checkpoints, in the reference's format."""
from repro_torch.checkpoint.checkpoint import config_hash, restore, save

__all__ = ["config_hash", "restore", "save"]
