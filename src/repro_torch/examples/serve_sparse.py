"""End-to-end example: serve an LM whose FFN weights are sparse -- the
paper's formats applied to the decode-MVM regime.

1. Initialize an LM; magnitude-prune layer 0's FFN gate block-wise.
2. Wrap it in SparseLinear (the format advisor picks BSR vs SELL).
3. Compare dense vs sparse-kernel FFN outputs + the modelled bytes/SpMV.
4. Generate tokens through the engine.

    PYTHONPATH=src python -m repro_torch.examples.serve_sparse --device cpu
    PYTHONPATH=src python -m repro_torch.examples.serve_sparse --full

The default model is Qwen3-0.6B ``reduced`` to d_model 128, d_ff 512, two
layers; ``--full`` serves its published widths uncut.  Runs on the card
unless ``--device`` names another device; the layer runs the hand-written
kernel there and its plain version on the host (``backend="auto"``).
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..configs import reduced
from ..core.perfmodel import LINE128_FP32
from ..models.registry import Model, get_config
from ..models.sparse import SparseLinear, magnitude_prune, sparsity_report
from ..serve.engine import Engine, GenerationConfig
from ..utils.hw import default_device

#: the pruning of step 1: a quarter of the weights kept, in (8, 128) blocks
DENSITY, BLOCK = 0.25, (8, 128)


def model_config(full: bool = False):
    """Qwen3-0.6B at its published widths, or the example's reduced cut."""
    cfg = get_config("qwen3-0.6b")
    return cfg if full else reduced(cfg, d_model=128, d_ff=512, n_layers=2)


def gate_weight(params) -> np.ndarray:
    """Layer 0's FFN gate as a (d_ff, d_model) host array."""
    return params.units[0].mlp.wi_gate.detach().T.cpu().numpy()


def sparse_gate(w: np.ndarray, dev: torch.device, d_model: int) -> dict:
    """Prune ``w``, advise, build the ``SparseLinear`` and hold it against
    the dense product on four seeded activation rows."""
    w_sparse = magnitude_prune(w, density=DENSITY, structured=BLOCK)
    rep = sparsity_report(w_sparse, BLOCK)
    print(f"[sparse] FFN weight {w.shape}: density={DENSITY:.0%} block{BLOCK} "
          f"-> advisor: {rep['advised_format']}")
    lin = SparseLinear.from_dense(w_sparse, fmt="auto", block_shape=BLOCK, backend="auto",
                                  device=dev)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (4, d_model)).astype(np.float32)).to(dev)
    y_sparse = lin(x)
    y_dense = x @ torch.from_numpy(w_sparse).to(dev).T
    err = float((y_sparse - y_dense).abs().max())
    rel = err / float(y_dense.abs().max())
    streamed = lin.streamed_bytes(LINE128_FP32)
    print(f"[sparse] kernel-vs-dense max err = {err:.2e} ({rel:.2e} relative) "
          f"[{lin.fmt} on {dev}]; streamed ~{streamed / 1e3:.1f} KB/SpMV "
          f"vs dense {w.size * 4 / 1e3:.1f} KB")
    return {"w_sparse": w_sparse, "report": rep, "layer": lin, "x": x, "y_sparse": y_sparse,
            "y_dense": y_dense, "err": err, "rel_err": rel, "streamed_bytes": streamed}


def serve(model: Model, params, dev: torch.device) -> dict:
    """Two seeded prompts through the engine, 12 greedy tokens each."""
    eng = Engine(model, params, batch_size=2, max_len=64, device=dev)
    prompts = np.random.default_rng(0).integers(0, model.cfg.vocab, (2, 8)).astype(np.int32)
    gen_cfg = GenerationConfig(max_new_tokens=12)
    outs = eng.generate(prompts, gen_cfg)
    for i, o in enumerate(outs):
        print(f"[serve] request {i}: {o}")
    bpt = eng.decode_bytes_per_token()
    print(f"[serve] ~{bpt / 1e6:.2f} MB streamed per token "
          f"(weights + cache/slot) -- the decode-MVM bandwidth regime")
    return {"engine": eng, "prompts": prompts, "gen_cfg": gen_cfg, "outs": outs,
            "decode_bytes_per_token": bpt}


def main(argv=None) -> dict:
    """Steps 1-4; returns the config, the sparse-gate record and the served
    record."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="Qwen3-0.6B's published widths, uncut")
    ap.add_argument("--device", default=None,
                    help="device to serve on (default: the card; 'cpu' for the host)")
    args = ap.parse_args(argv)
    dev = default_device(args.device)
    cfg = model_config(args.full)
    model = Model(cfg)
    params = model.init(torch.Generator(device=dev).manual_seed(0), device=dev)
    gate = sparse_gate(gate_weight(params), dev, cfg.d_model)
    served = serve(model, params, dev)
    return {"config": cfg, "gate": gate, **served}


if __name__ == "__main__":
    main()
