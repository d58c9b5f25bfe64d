"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.transformer import ModelConfig


def gemma_7b() -> ModelConfig:
    # [arXiv:2403.08295; hf] GeGLU, head_dim=256, MHA (kv=16)
    return ModelConfig(
        name="gemma-7b", family="dense", n_layers=28, d_model=3072,
        n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576, vocab=256000,
        act="gelu", tie_embeddings=True, embed_scale=True,
        source="arXiv:2403.08295; hf",
    )


config = gemma_7b
