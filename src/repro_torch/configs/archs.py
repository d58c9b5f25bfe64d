"""The 10 assigned architectures: aggregation + registry hookup.

Each architecture lives in its own module (``configs/<id>.py`` per the
assignment); this module collects them and registers every config with the
model registry under its assigned id.
"""
from __future__ import annotations

from ..models.registry import register
from .gemma_7b import gemma_7b
from .qwen3_0p6b import qwen3_0p6b
from .minicpm_2b import minicpm_2b
from .glm4_9b import glm4_9b
from .pixtral_12b import pixtral_12b
from .moonshot_v1_16b_a3b import moonshot_16b_a3b
from .deepseek_v2_lite_16b import deepseek_v2_lite
from .mamba2_2p7b import mamba2_2p7b
from .whisper_tiny import whisper_tiny
from .jamba_1p5_large_398b import jamba_1p5_large

ARCHS = {
    "gemma-7b": gemma_7b,
    "qwen3-0.6b": qwen3_0p6b,
    "minicpm-2b": minicpm_2b,
    "glm4-9b": glm4_9b,
    "pixtral-12b": pixtral_12b,
    "moonshot-v1-16b-a3b": moonshot_16b_a3b,
    "deepseek-v2-lite-16b": deepseek_v2_lite,
    "mamba2-2.7b": mamba2_2p7b,
    "whisper-tiny": whisper_tiny,
    "jamba-1.5-large-398b": jamba_1p5_large,
}

for _name, _fn in ARCHS.items():
    register(_name, _fn)
