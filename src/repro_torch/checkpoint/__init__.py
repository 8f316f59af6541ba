"""Checkpoints of the port, in the reference's on-disk layout."""
from repro_torch.checkpoint.manager import CheckpointManager  # noqa: F401
