"""Modality frontends -- stubs, as in the reference.

The ``[audio]`` / ``[vlm]`` architectures specify the transformer backbone
only; ``configs.base.input_specs`` provides precomputed frame / patch
embeddings.  These helpers draw deterministic fake embeddings of the right
shape and dtype from an explicit ``torch.Generator`` (on its device), and
document what the real frontends would compute.
"""
from __future__ import annotations

import torch

from ..utils.tree import TensorSpec


def vit_patch_embeddings_stub(gen: torch.Generator, batch: int, seq: int, d_model: int,
                              dtype=torch.bfloat16) -> torch.Tensor:
    """Pixtral: real path = ViT over image patches (conv patchify + RoPE-2D
    blocks), one embedding per patch interleaved with text.  Stub:
    unit-variance random embeddings (B, S, D)."""
    return torch.randn((batch, seq, d_model), generator=gen, device=gen.device).to(dtype)


def audio_frame_embeddings_stub(gen: torch.Generator, batch: int, frames: int, d_model: int,
                                dtype=torch.bfloat16) -> torch.Tensor:
    """Whisper: real path = log-mel spectrogram -> two strided Conv1d + GELU
    + sinusoidal positions.  Stub: random frame embeddings (B, frames, D)."""
    return torch.randn((batch, frames, d_model), generator=gen, device=gen.device).to(dtype)


def embeds_spec(batch: int, seq: int, d_model: int, dtype=torch.bfloat16) -> TensorSpec:
    return TensorSpec((batch, seq, d_model), dtype)
