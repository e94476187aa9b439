"""Checkpointing: atomic, async, keep-k (the JAX package's on-disk
layout, so each package reads what the other writes)."""

from repro_torch.ckpt.checkpoint import (  # noqa: F401
    CheckpointManager,
    list_checkpoints,
    load_checkpoint,
    read_metadata,
    save_checkpoint,
)
