"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.transformer import ModelConfig


def whisper_tiny() -> ModelConfig:
    # [arXiv:2212.04356; unverified] enc-dec; conv frontend stubbed
    return ModelConfig(
        name="whisper-tiny", family="encdec", n_layers=4, d_model=384,
        n_heads=6, n_kv_heads=6, head_dim=64, d_ff=1536, vocab=51865,
        n_enc_layers=4, act="gelu", tie_embeddings=True,
        source="arXiv:2212.04356; unverified",
        notes="[audio] backbone only; learned positions -> RoPE "
              "(structural fidelity).",
    )


config = whisper_tiny
