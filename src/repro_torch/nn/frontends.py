"""Modality frontend stubs: the JAX package's ``repro/nn/frontends.py``.

The reference serves the backbone only: pixtral-12b's ViT and whisper's
convolutional frontend are stubs that hand the decoder (or encoder)
unit-variance embeddings.  These draw them from an explicit
``torch.Generator`` (the reference's ``jax.random`` key has no torch twin:
the parity tests draw the embeddings with JAX and feed both packages).
"""

from __future__ import annotations

import torch


def vision_patch_stub(generator: torch.Generator, batch: int,
                      n_patches: int, d_model: int, dtype=torch.float32):
    """Pixtral-ViT stand-in: unit-variance patch embeddings (B, n_patches,
    d_model) on the generator's device."""
    return torch.randn((batch, n_patches, d_model), generator=generator,
                       device=generator.device, dtype=dtype)


def audio_frame_stub(generator: torch.Generator, batch: int, n_frames: int,
                     d_model: int, dtype=torch.float32):
    """Whisper conv-frontend stand-in: unit-variance frame embeddings (B,
    n_frames, d_model) on the generator's device."""
    return torch.randn((batch, n_frames, d_model), generator=generator,
                       device=generator.device, dtype=dtype)
