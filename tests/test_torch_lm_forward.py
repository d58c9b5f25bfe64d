"""The port's models at the reduced size on the reference's parameters, for
every architecture: ``lm_forward`` (1e-4 relative at f32 compute, 3e-2 at
bf16 compute: bf16 activations rounded and summed in another order),
``lm_loss``, prefill and decode (the reference's prefill / decode
invariant, and the reference's own prefill and decode step), and the MoE
archs' ``dropped_frac``."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_lm import (ARCHS, MOE_ARCHS, as_port, as_ref, configs, np_inputs,  # noqa: E402
                       port_module, ref_params, rel, rj)
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.models import whisper as W  # noqa: E402
from repro_torch.utils import tree as TREE  # noqa: E402

BF16_TOL = 3e-2


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


# --- forward, loss, prefill / decode at the reduced size -------------------------------


def _ref_forward(name: str, compute: str, inputs: dict):
    from repro.models import transformer as RT
    from repro.models import whisper as RW
    rm, rp = ref_params(name, compute)
    cfg = rm.cfg
    if cfg.family == "encdec":
        def fwd(p, enc, toks):
            return RW.decode(p, cfg, toks, RW.encode(p, cfg, enc))[0]
        return jax.jit(fwd)(rp, as_ref(inputs["enc_embeds"]), as_ref(inputs["tokens"]))
    x = inputs["embeds"] if cfg.input_mode == "embeds" else inputs["tokens"]
    return rj(RT.lm_forward, cfg=cfg)(rp, inputs=as_ref(x))[0]


def _port_forward(name: str, compute: str, inputs: dict):
    model, module = port_module(name, compute)
    cfg = model.cfg
    if cfg.family == "encdec":
        enc = W.encode(module, cfg, as_port(inputs["enc_embeds"]))
        return W.decode(module, cfg, as_port(inputs["tokens"]), enc)[0]
    x = inputs["embeds"] if cfg.input_mode == "embeds" else inputs["tokens"]
    return T.lm_forward(module, cfg, as_port(x))[0]


@pytest.mark.parametrize("name", ARCHS)
def test_lm_forward_matches_reference_f32(name):
    inputs = np_inputs(configs(name)[1], 2, 17)
    got = _port_forward(name, "float32", inputs)
    want = _ref_forward(name, "float32", inputs)
    assert got.dtype == torch.float32 and tuple(got.shape) == tuple(want.shape)
    assert rel(got, want) <= 1e-4


def _routes(records: list, B: int, S: int) -> tuple[np.ndarray, np.ndarray]:
    """(probs (calls, B, S, E), experts (calls, B, S, K)) of the top-k calls
    recorded in call order, one per dispatch group: each MoE call's groups
    cover its B * S tokens in order."""
    probs = np.concatenate([p for p, _ in records]) if records else np.zeros((0, 1))
    tope = np.concatenate([e for _, e in records]) if records else np.zeros((0, 1))
    return (probs.reshape(-1, B, S, probs.shape[-1]),
            np.sort(tope, -1).reshape(-1, B, S, tope.shape[-1]))


@pytest.mark.parametrize("name", ARCHS)
def test_lm_forward_matches_reference_bf16(name, monkeypatch):
    """Every position within BF16_TOL of max|logits|, up to the first token
    of its row whose bf16 routing picked other top-k experts than the
    reference's. That token must be a near tie that rounding tipped: the
    reference's K-th and (K+1)-th router probabilities within ROUTE_TIE,
    and every router probability before it within ROUTE_TIE of the
    reference's. From there on the flip moves the row as a whole (through
    attention and the SSM state), so the row is held to nothing more."""
    ROUTE_TIE = 5e-3
    B, S = 2, 16
    port_rec, ref_rec = [], []
    topk_t, topk_j = torch.topk, jax.lax.top_k

    def rec_t(x, k, dim=-1, **kw):
        w, e = topk_t(x, k, dim=dim, **kw)
        port_rec.append((x.float().numpy().copy(), e.numpy().copy()))
        return w, e

    def rec_j(x, k):
        w, e = topk_j(x, k)
        jax.debug.callback(lambda p_, e_: ref_rec.append((np.asarray(p_), np.asarray(e_))),
                           x, e, ordered=True)
        return w, e

    monkeypatch.setattr(torch, "topk", rec_t)
    monkeypatch.setattr(jax.lax, "top_k", rec_j)
    inputs = np_inputs(configs(name)[1], B, S, seed=1)
    got = _port_forward(name, "bfloat16", inputs)
    want = np.asarray(_ref_forward(name, "bfloat16", inputs), np.float64)
    jax.effects_barrier()
    assert got.dtype == torch.float32 and bool(torch.isfinite(got).all())
    per_pos = np.abs(got.double().numpy() - want).max(-1) / np.abs(want).max()

    assert len(port_rec) == len(ref_rec) and (len(port_rec) > 0) == (name in MOE_ARCHS)
    p_port, e_port = _routes(port_rec, B, S)
    p_ref, e_ref = _routes(ref_rec, B, S)
    flipped = (e_port != e_ref).any(-1)                                 # (calls, B, S)
    for b in range(B):
        hits = np.argwhere(flipped[:, b])                               # (call, s) pairs
        s0 = int(hits[:, 1].min()) if len(hits) else S
        assert np.abs(p_port[:, b, :s0] - p_ref[:, b, :s0]).max(initial=0.0) <= ROUTE_TIE
        if s0 < S:
            c0 = int(hits[hits[:, 1] == s0, 0].min())
            ranked = np.sort(p_ref[c0, b, s0])[::-1]
            K = e_ref.shape[-1]
            assert ranked[K - 1] - ranked[K] <= ROUTE_TIE, (b, s0, ranked)
        assert per_pos[b, :s0].max(initial=0.0) <= BF16_TOL, (b, s0, per_pos[b])


@pytest.mark.parametrize("name", ARCHS)
def test_loss_matches_reference(name):
    rm, rp = ref_params(name, "float32")
    model, module = port_module(name, "float32")
    inputs = np_inputs(model.cfg, 2, 16, seed=2)
    labels = np.random.default_rng(9).integers(0, model.cfg.vocab, (2, 16)).astype(np.int32)
    key = "embeds" if "embeds" in inputs else "tokens"
    batch = {k: v for k, v in inputs.items() if k in ("enc_embeds", key)} | {"labels": labels}
    loss, metrics = model.loss(module, {k: as_port(v) for k, v in batch.items()})
    loss_r, metrics_r = jax.jit(rm.loss)(rp, {k: as_ref(v) for k, v in batch.items()})
    assert set(metrics) == set(metrics_r)
    assert float(loss) == pytest.approx(float(loss_r), rel=1e-5)
    for k in metrics:
        assert float(metrics[k]) == pytest.approx(float(metrics_r[k]), rel=1e-4, abs=1e-8)


def _prefill_decode(model, module, inputs: dict, S: int, cache):
    """(prefill logits, decode logits) of the first S positions and the next."""
    if model.cfg.family == "encdec":
        pre = {"enc_embeds": as_port(inputs["enc_embeds"]),
               "tokens": as_port(inputs["tokens"][:, :S])}
        nxt = as_port(inputs["tokens"][:, S])
    elif model.cfg.input_mode == "embeds":
        pre, nxt = {"embeds": as_port(inputs["embeds"][:, :S])}, as_port(inputs["embeds"][:, S])
    else:
        pre, nxt = {"tokens": as_port(inputs["tokens"][:, :S])}, as_port(inputs["tokens"][:, S])
    lg_pre, cache = model.prefill(module, pre, cache)
    lg_dec, cache = model.decode_step(module, cache, nxt, S)
    return lg_pre, lg_dec, cache


@pytest.mark.parametrize("name", ARCHS)
def test_prefill_decode_consistency_and_reference(name):
    """The reference's invariant (tests/test_models.py): prefill's last
    logits and one decode step equal the full forward at S - 1 and S; and
    both equal the reference's prefill and decode step."""
    B, S = 2, 16
    model, module = port_module(name, "float32")
    inputs = np_inputs(model.cfg, B, S + 1, seed=3)
    full = _port_forward(name, "float32", inputs)
    cache = model.init_cache(B, S + 4, device="cpu")
    lg_pre, lg_dec, cache = _prefill_decode(model, module, inputs, S, cache)
    scale = float(full.abs().max())
    assert float((lg_pre - full[:, S - 1]).abs().max()) / scale < 1e-4
    assert float((lg_dec - full[:, S]).abs().max()) / scale < 1e-4

    rm, rp = ref_params(name, "float32")
    rcache = rm.init_cache(B, S + 4)
    if model.cfg.family == "encdec":
        rpre = {"enc_embeds": as_ref(inputs["enc_embeds"]),
                "tokens": as_ref(inputs["tokens"][:, :S])}
        rnxt = as_ref(inputs["tokens"][:, S])
    else:
        key = "embeds" if model.cfg.input_mode == "embeds" else "tokens"
        rpre, rnxt = {key: as_ref(inputs[key][:, :S])}, as_ref(inputs[key][:, S])
    rlg_pre, rcache = jax.jit(rm.prefill)(rp, rpre, rcache)
    rlg_dec, rcache = jax.jit(rm.decode_step)(rp, rcache, rnxt, jnp.int32(S))
    assert rel(lg_pre, rlg_pre) <= 1e-4 and rel(lg_dec, rlg_dec) <= 1e-4
    for (path, got), (_, want) in zip(TREE.flatten_with_paths(cache),
                                      TREE.flatten_with_paths(
                                          jax.tree.map(np.asarray, rcache))):
        assert got.dtype == torch.float32 and rel(got, want) <= 1e-4, path


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_archs_report_dropped_frac(name):
    from repro.models import moe as RMOE
    from repro.models.layers import apply_rmsnorm as r_norm
    from repro_torch.models import moe as MOE
    from repro_torch.models.layers import apply_rmsnorm
    rm, rp = ref_params(name, "float32")
    model, module = port_module(name, "float32")
    cfg = model.cfg
    unit = module.units[0] if cfg.family != "hybrid" else module.units[0].l1
    runit = jax.tree.map(lambda a: a[0], rp["units"])
    runit = runit if cfg.family != "hybrid" else runit["l1"]
    x = np.random.default_rng(4).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    y, aux = MOE.moe_apply(unit.moe, apply_rmsnorm(unit.ln_ffn, as_port(x)), cfg.moe,
                           compute_dtype=torch.float32)
    y_r, aux_r = rj(RMOE.moe_apply, cfg=rm.cfg.moe, compute_dtype=jnp.float32)(
        runit["moe"], r_norm(runit["ln_ffn"], as_ref(x)))
    assert rel(y, y_r) <= 1e-5
    assert float(aux["dropped_frac"]) == float(aux_r["dropped_frac"])
