"""Shared body of the ``test_torch_train_parity*`` suites: one train step of
an architecture's ``reduced`` config, in the port and in the reference, from
the same parameters (the reference's, carried across) on the same
``smoke_batch``, at f32 compute.

Tolerances: loss and ``grad_norm`` 1e-5 relative; each grad leaf within
1e-4 of the leaf's max|g|.  The parameters after the step are held to
``2 * lr`` absolute: AdamW's first step moves an element by about
``lr * sign(g)`` (``mhat / sqrt(vhat)`` is ``g / (|g| + eps)``), so an element
whose grad is near 0 in both packages may move by +-lr in each.  Where the
grad is clearly away from 0 (|g| above 1e-3 of the leaf's max, ten times the
grad tolerance) the sign is settled, and there the parameters are held to
1e-6 absolute.

A bf16 leaf (jamba keeps its parameters in bf16) has its grad and its
updated value rounded to bf16, and two f32 results 1e-7 apart can round to
neighbouring bf16 values: such a leaf is held to one bf16 unit in the last
place (2^-7 of its max|g|, of |p| after the step).  ``f32_params=True``
runs the same architecture with f32 parameters in both packages (the bf16
values carried across exactly) and holds it to the f32 tolerances.
"""

import jax
import pytest
import numpy as np
import torch

from _torch_lm import configs, port_module, ref_params, rel
from repro_torch.interop import as_tensor, lm_state_from_reference, opt_state_from_reference
from repro_torch.train import optimizer as PO
from repro_torch.train import trainer as PT
from repro_torch.utils.tree import global_norm

LR = 1e-2
OPT = dict(lr=LR, warmup_steps=1, schedule="const")


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _models(name: str, f32_params: bool):
    """(reference model and params, port model and module) at f32 compute."""
    from repro.models.registry import Model as RModel
    from repro_torch.models.registry import Model
    rm, rp = ref_params(name, "float32")
    model, module = port_module(name, "float32")
    if not f32_params:
        return rm, rp, model, module
    rcfg, cfg = configs(name, compute_dtype="float32", cache_dtype="float32",
                        param_dtype="float32")
    rp = jax.tree.map(lambda a: a.astype(np.float32), rp)
    model = Model(cfg)
    module = model.build("cpu")
    module.load_state_dict(lm_state_from_reference(cfg, _np(rp)))
    return RModel(rcfg), rp, model, module


def _ref_step(rm, rp):
    """(batch as numpy, grads, (params, opt state, metrics) after one step) of
    the reference."""
    from repro.configs import smoke_batch
    from repro.train.optimizer import OptimizerConfig, init_opt_state
    from repro.train.trainer import make_train_step
    batch = smoke_batch(rm.cfg)
    step = make_train_step(rm, OptimizerConfig(**OPT), donate=False)

    def both(p, o, b):
        grads = jax.grad(lambda q: rm.loss(q, b)[0])(p)
        return grads, step(p, o, b)

    grads, out = jax.jit(both)(rp, init_opt_state(rp), batch)
    return _np(batch), _np(grads), _np(out)


def _tol(t: torch.Tensor, f32_tol: float) -> float:
    return 2.0 ** -7 if t.dtype == torch.bfloat16 else f32_tol


def _leaf_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max|got - want| / max|want| of one leaf (0 for an all-zero leaf)."""
    g, w = got.double(), want.double()
    scale = float(w.abs().max())
    return float((g - w).abs().max()) / scale if scale else float((g - w).abs().max())


def check_train_step(name: str, f32_params: bool = False):
    rm, rp, model, module = _models(name, f32_params)
    batch, rgrads, (rparams, ropt, rmet) = _ref_step(rm, rp)
    cfg = model.cfg
    pbatch = {k: as_tensor(v) for k, v in batch.items()}
    params0 = {k: p.detach().clone() for k, p in module.named_parameters()}

    loss, _, grads = PT.loss_and_grads(model, module, pbatch)
    assert rel(loss, rmet["loss"]) <= 1e-5
    want_g = lm_state_from_reference(cfg, rgrads)
    assert set(grads) == set(want_g)
    errs = {k: _leaf_err(grads[k], want_g[k]) / _tol(grads[k], 1e-4) for k in grads}
    assert max(errs.values()) <= 1, sorted(errs.items(), key=lambda kv: -kv[1])[:3]
    assert rel(global_norm(grads), rmet["grad_norm"]) <= 1e-5

    opt = PO.init_opt_state(module)
    _, opt, met = PT.make_train_step(model, PO.OptimizerConfig(**OPT))(module, opt, pbatch)
    assert rel(met["loss"], rmet["loss"]) <= 1e-5
    assert rel(met["grad_norm"], rmet["grad_norm"]) <= 1e-5
    assert float(met["lr"]) == pytest.approx(float(rmet["lr"]), rel=1e-7) == LR
    assert not met["skipped"] and not bool(rmet["skipped"])

    want_p = lm_state_from_reference(cfg, rparams)
    want_opt = opt_state_from_reference(cfg, ropt)
    assert int(opt["step"]) == int(want_opt["step"]) == 1
    for k, p in module.named_parameters():
        d = (p.detach().double() - want_p[k].double()).abs()
        assert float(d.max()) <= 2 * LR, k
        settled = want_g[k].double().abs() > 1e-3 * float(want_g[k].double().abs().max())
        bound = (_tol(p, 0.0) * p.detach().double().abs()).clamp(min=1e-6)
        assert bool((torch.where(settled, d, 0.0) <= bound).all()), k
        # the step moved what it should: decayed leaves and signed updates
        assert float((p.detach().double() - params0[k].double()).abs().max()) > 0 or \
            float(want_g[k].abs().max()) == 0, k
        # first moment: (1 - b1) * clipped g, held as the grads are
        assert _leaf_err(opt["m"][k], want_opt["m"][k]) <= _tol(p, 1e-4), k
