"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.transformer import ModelConfig


def glm4_9b() -> ModelConfig:
    # [hf:THUDM/glm-4-9b; hf] extreme GQA: kv=2
    return ModelConfig(
        name="glm4-9b", family="dense", n_layers=40, d_model=4096,
        n_heads=32, n_kv_heads=2, head_dim=128, d_ff=13696, vocab=151552,
        tie_embeddings=False,
        source="hf:THUDM/glm-4-9b; hf",
        notes="glm4 partial-rotary (50%) simplified to full RoPE.",
    )


config = glm4_9b
