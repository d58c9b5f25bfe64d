"""Deterministic synthetic token pipeline with O(1) skip-ahead.

Every batch is a pure function of (seed, step): resuming from a checkpoint
at step N replays the exact stream by setting the counter -- no state files,
no epoch bookkeeping, identical across hosts (each host slices its shard of
the global batch by host index).

Token statistics are Zipfian with local n-gram correlations, so the LM loss
has structure to learn.  The draws are numpy's, the reference's bit for bit;
``batch_at`` returns them as tensors on the pipeline's device (tokens and
labels int32, embeddings bf16 cast through torch, which rounds to nearest
even as ``ml_dtypes`` does).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.hw import default_device


@dataclass
class PipelineConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.3
    ngram_period: int = 16       # injected periodic structure (learnable signal)
    host_index: int = 0
    host_count: int = 1


class TokenPipeline:
    def __init__(self, cfg: PipelineConfig, device=None):
        """Batches land on ``device`` (default the card)."""
        self.cfg = cfg
        self.device = default_device(device)
        self.step = 0
        assert cfg.global_batch % cfg.host_count == 0
        self._local_batch = cfg.global_batch // cfg.host_count

    def skip_to(self, step: int):
        self.step = int(step)

    def _rng(self, step: int) -> np.random.Generator:
        # independent stream per (seed, step, host)
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, self.cfg.host_index]))

    def arrays_at(self, step: int) -> dict:
        """The batch of ``step`` as the reference's numpy arrays."""
        cfg = self.cfg
        rng = self._rng(step)
        B, S = self._local_batch, cfg.seq_len
        # Zipf body tokens
        toks = rng.zipf(cfg.zipf_a, size=(B, S + 1)).astype(np.int64)
        toks = np.minimum(toks, cfg.vocab - 1)
        # periodic n-gram structure: token at t depends on t % period
        phase = (np.arange(S + 1) % cfg.ngram_period)
        toks = (toks + phase[None, :] * 7) % cfg.vocab
        return {"tokens": toks[:, :-1].astype(np.int32),
                "labels": toks[:, 1:].astype(np.int32)}

    def batch_at(self, step: int) -> dict:
        return {k: _to_device(v, self.device) for k, v in self.arrays_at(step).items()}

    def next_batch(self) -> dict:
        b = self.batch_at(self.step)
        self.step += 1
        return b

    def __iter__(self):
        while True:
            yield self.next_batch()


def _to_device(a, device) -> torch.Tensor:
    """A numpy array as a tensor on ``device``; f32 embeddings become bf16
    (rounded on the host, then moved)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype == torch.float32:
        t = t.to(torch.bfloat16)
    return t.to(device)


class EmbedsPipeline(TokenPipeline):
    """For embeds-input archs (vlm stub): deterministic patch embeddings."""

    def __init__(self, cfg: PipelineConfig, d_model: int, device=None):
        super().__init__(cfg, device)
        self.d_model = d_model

    def arrays_at(self, step: int) -> dict:
        """Labels, and the f32 draws of the embeddings (bf16 in ``batch_at``)."""
        base = super().arrays_at(step)
        rng = self._rng(step * 2 + 1)
        B, S = self._local_batch, self.cfg.seq_len
        emb = rng.standard_normal((B, S, self.d_model), dtype=np.float32)
        return {"embeds": emb, "labels": base["labels"]}


class EncDecPipeline(TokenPipeline):
    """For encoder-decoder archs (audio stub): frame embeddings + tokens."""

    def __init__(self, cfg: PipelineConfig, d_model: int, device=None):
        super().__init__(cfg, device)
        self.d_model = d_model

    def arrays_at(self, step: int) -> dict:
        """Tokens, labels, and the f32 draws of the frame embeddings."""
        base = super().arrays_at(step)
        rng = self._rng(step * 2 + 1)
        B, S = self._local_batch, self.cfg.seq_len
        emb = rng.standard_normal((B, S, self.d_model), dtype=np.float32)
        return {"enc_embeds": emb, "tokens": base["tokens"], "labels": base["labels"]}


def pipeline_for(cfg_model, shape_batch: int, seq_len: int, seed: int = 0, device=None):
    pcfg = PipelineConfig(vocab=cfg_model.vocab, seq_len=seq_len,
                          global_batch=shape_batch, seed=seed)
    if cfg_model.family == "encdec":
        return EncDecPipeline(pcfg, cfg_model.d_model, device)
    if cfg_model.input_mode == "embeds":
        return EmbedsPipeline(pcfg, cfg_model.d_model, device)
    return TokenPipeline(pcfg, device)
