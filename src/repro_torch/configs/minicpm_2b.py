"""Assigned-architecture config (see archs.py for the full table)."""
from ..models.transformer import ModelConfig


def minicpm_2b() -> ModelConfig:
    # [arXiv:2404.06395; hf] llama-like; WSD handled by the optimizer
    return ModelConfig(
        name="minicpm-2b", family="dense", n_layers=40, d_model=2304,
        n_heads=36, n_kv_heads=36, head_dim=64, d_ff=5760, vocab=122753,
        tie_embeddings=True,
        source="arXiv:2404.06395; hf",
        notes="WSD schedule is an optimizer property (train/optimizer.py); "
              "minicpm's mup-style scale_emb/scale_depth multipliers omitted "
              "(structural fidelity).",
    )


config = minicpm_2b
