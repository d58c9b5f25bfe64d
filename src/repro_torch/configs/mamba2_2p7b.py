"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.mamba2 import SSMConfig
from ..models.transformer import ModelConfig


def mamba2_2p7b() -> ModelConfig:
    # [arXiv:2405.21060; unverified] attention-free SSD
    return ModelConfig(
        name="mamba2-2.7b", family="ssm", n_layers=64, d_model=2560,
        n_heads=0, n_kv_heads=0, head_dim=0, d_ff=0, vocab=50280,
        ssm=SSMConfig(d_model=2560, d_state=128, head_dim=64, expand=2),
        tie_embeddings=True,
        source="arXiv:2405.21060; unverified",
    )


config = mamba2_2p7b
