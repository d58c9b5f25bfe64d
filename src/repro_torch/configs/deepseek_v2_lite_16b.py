"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.attention import MLAConfig
from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig


def deepseek_v2_lite() -> ModelConfig:
    # [arXiv:2405.04434; hf] MLA kv_lora=512; 64 routed top-6 + 2 shared
    return ModelConfig(
        name="deepseek-v2-lite-16b", family="moe", n_layers=27, d_model=2048,
        n_heads=16, n_kv_heads=16, head_dim=128, d_ff=1408, vocab=102400,
        mla=MLAConfig(d_model=2048, n_heads=16, kv_lora=512, rope_dim=64,
                      nope_dim=128, v_dim=128),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2),
        first_dense=1, dense_ff=10944, tie_embeddings=False,
        source="arXiv:2405.04434; hf",
        notes="assignment note mentions '160 routed' (full V2); lite config "
              "is 64 routed top-6 + 2 shared per hf config.",
    )


config = deepseek_v2_lite
