"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.transformer import ModelConfig


def qwen3_0p6b() -> ModelConfig:
    # [hf:Qwen/Qwen3-8B family; hf] qk_norm, GQA kv=8, head_dim=128
    return ModelConfig(
        name="qwen3-0.6b", family="dense", n_layers=28, d_model=1024,
        n_heads=16, n_kv_heads=8, head_dim=128, d_ff=3072, vocab=151936,
        qk_norm=True, rope_theta=1e6, tie_embeddings=True,
        source="hf:Qwen/Qwen3-0.6B; hf",
    )


config = qwen3_0p6b
