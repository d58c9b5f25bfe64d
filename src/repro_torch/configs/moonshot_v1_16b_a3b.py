"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig


def moonshot_16b_a3b() -> ModelConfig:
    # [hf:moonshotai/Moonlight-16B-A3B; hf] 64 routed top-6 (+2 shared, layer0 dense)
    return ModelConfig(
        name="moonshot-v1-16b-a3b", family="moe", n_layers=48, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=163840,
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
        first_dense=1, dense_ff=11264, tie_embeddings=True,
        source="hf:moonshotai/Moonlight-16B-A3B; hf",
        notes="deepseek-v3-style recipe: 2 shared experts + first dense layer.",
    )


config = moonshot_16b_a3b
