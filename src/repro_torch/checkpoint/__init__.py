from repro_torch.checkpoint.checkpoint import CheckpointManager, ChecksumError

__all__ = ["CheckpointManager", "ChecksumError"]
