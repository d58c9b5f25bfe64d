"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.transformer import ModelConfig


def pixtral_12b() -> ModelConfig:
    # [hf:mistralai/Pixtral-12B-2409; unverified] ViT frontend stubbed
    return ModelConfig(
        name="pixtral-12b", family="dense", n_layers=40, d_model=5120,
        n_heads=32, n_kv_heads=8, head_dim=128, d_ff=14336, vocab=131072,
        rope_theta=1e6, tie_embeddings=False, input_mode="embeds",
        source="hf:mistralai/Pixtral-12B-2409; unverified",
        notes="[vlm] backbone only; input_specs feeds precomputed patch "
              "embeddings (frontends.vit_patch_embeddings_stub).",
    )


config = pixtral_12b
