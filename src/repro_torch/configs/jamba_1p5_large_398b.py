"""Assigned-architecture config (see archs.py for the full table)."""
import torch

from ..models.mamba2 import SSMConfig
from ..models.moe import MoEConfig
from ..models.transformer import ModelConfig


def jamba_1p5_large() -> ModelConfig:
    # [arXiv:2403.19887; hf] 1:7 attn:mamba interleave, MoE every other layer
    return ModelConfig(
        name="jamba-1.5-large-398b", family="hybrid", n_layers=72,
        d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128, d_ff=24576,
        vocab=65536,
        ssm=SSMConfig(d_model=8192, d_state=128, head_dim=64, expand=2),
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576),
        hybrid_period=8, hybrid_attn_idx=4, tie_embeddings=False,
        # 398B params: FSDP param sharding + bf16 params / moments, as the
        # reference sizes it (the sharding fields are data in this slice).
        fsdp=True, param_dtype=torch.bfloat16, opt_dtype=torch.bfloat16,
        source="arXiv:2403.19887; hf",
        notes="Jamba uses Mamba-1 (d_state=16) internally; adapted to the "
              "Mamba-2 SSD layer (d_state=128) per this repo's SSM substrate "
              "- see DESIGN.md.",
    )


config = jamba_1p5_large
