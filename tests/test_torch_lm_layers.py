"""The LM blocks of the port -- norms, RoPE, gated MLP, loss, masks,
attention (flash, decode, GQA and MLA with a cache), MoE dispatch, Mamba-2
-- against the reference's on the same seeded numpy inputs and the same
parameters, f32 compute (1e-5 relative unless stated)."""
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from _torch_lm import as_port, as_ref, rel, rj  # noqa: E402
from repro.models import attention as RA  # noqa: E402
from repro.models import layers as RL  # noqa: E402
from repro.models import mamba2 as RM2  # noqa: E402
from repro.models import moe as RMOE  # noqa: E402
from repro_torch.interop import as_tensor  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import mamba2 as M2  # noqa: E402
from repro_torch.models import moe as MOE  # noqa: E402

F32 = torch.float32


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


def _load(module, ref_tree: dict):
    """The reference's parameter dict (nested) into ``module``, by name."""
    from repro_torch.utils.tree import flatten_with_paths
    state = {p.replace("/", "."): as_tensor(np.asarray(v))
             for p, v in flatten_with_paths(jax.tree.map(np.asarray, ref_tree))}
    module.load_state_dict(state)
    return module


def _randn(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# --- layers --------------------------------------------------------------------


def test_rmsnorm_qknorm_rope_match_reference():
    x = _randn(0, 2, 9, 4, 16)
    scale = 1.0 + 0.1 * _randn(1, 16)
    norm = L.RMSNorm(16, device="cpu")
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
    assert rel(L.apply_rmsnorm(norm, as_port(x)),
               RL.apply_rmsnorm({"scale": as_ref(scale)}, as_ref(x))) <= 1e-6
    assert rel(L.qk_norm_apply(torch.from_numpy(scale), as_port(x)),
               RL.qk_norm_apply(as_ref(scale), as_ref(x))) <= 1e-6
    pos = np.arange(3, 12)
    for theta in (1e4, 1e6):
        assert rel(L.apply_rope(as_port(x), torch.from_numpy(pos), theta),
                   RL.apply_rope(as_ref(x), as_ref(pos), theta)) <= 1e-6


@pytest.mark.parametrize("act", ("silu", "gelu"))
@pytest.mark.parametrize("cd", ("float32", "bfloat16"))
def test_gated_mlp_matches_reference(act, cd):
    rp = rj(RL.mlp_init, d_model=32, d_ff=48)(jax.random.PRNGKey(0))
    mlp = _load(L.MLP(32, 48, device="cpu"), rp)
    x = _randn(1, 3, 5, 32)
    got = L.apply_mlp(mlp, as_port(x), act, getattr(torch, cd))
    want = rj(RL.apply_mlp, act=act, compute_dtype=getattr(jnp, cd))(rp, as_ref(x))
    assert got.dtype == getattr(torch, cd)
    assert rel(got, want) <= (1e-5 if cd == "float32" else 1e-2)


def test_embed_unembed_loss_masks_match_reference():
    table = _randn(0, 50, 16)
    emb = L.Embed(50, 16, device="cpu")
    with torch.no_grad():
        emb.table.copy_(torch.from_numpy(table))
    toks = np.random.default_rng(1).integers(0, 50, (2, 7))
    for cd in ("float32", "bfloat16"):
        e = L.apply_embed(emb, as_port(toks), getattr(torch, cd))
        assert rel(e, RL.apply_embed({"table": as_ref(table)}, as_ref(toks),
                                     getattr(jnp, cd))) == 0.0
        lg = L.apply_unembed(emb, e, getattr(torch, cd))
        assert lg.dtype == F32
        assert rel(lg, RL.apply_unembed({"table": as_ref(table)}, as_ref(e.float().numpy()),
                                        getattr(jnp, cd))) <= 1e-6
    logits = _randn(2, 2, 7, 50)
    labels = np.random.default_rng(3).integers(0, 50, (2, 7))
    labels[0, :3] = -1
    for z in (0.0, 1e-3):
        got = L.softmax_cross_entropy(as_port(logits), as_port(labels), z_loss=z)
        want = RL.softmax_cross_entropy(as_ref(logits), as_ref(labels), z_loss=z)
        assert abs(float(got) - float(want)) <= 1e-6 * abs(float(want))
    assert torch.equal(L.causal_mask(5, 9, 4), torch.from_numpy(
        np.asarray(RL.causal_mask(5, 9, 4))))
    assert torch.equal(L.sliding_mask(5, 9, 3, 4), torch.from_numpy(
        np.asarray(RL.sliding_mask(5, 9, 3, 4))))


# --- attention -----------------------------------------------------------------


@pytest.mark.parametrize("qc,kc,window", [(32, 32, None), (16, 64, None),
                                          (64, 16, 40), (128, 128, None)])
def test_flash_attention_matches_reference(qc, kc, window):
    B, S, H, K, hd = 2, 128, 4, 2, 16
    q, k, v = _randn(0, B, S, H, hd), _randn(1, B, S, K, hd), _randn(2, B, S, K, hd)
    for causal in (True, False):
        got = A.flash_attention(as_port(q), as_port(k), as_port(v), scale=hd ** -0.5,
                                causal=causal, window=window, q_chunk=qc, k_chunk=kc)
        want = rj(RA.flash_attention, scale=hd ** -0.5, causal=causal, window=window,
                  q_chunk=qc, k_chunk=kc)(as_ref(q), as_ref(k), as_ref(v))
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= 2e-6


def test_flash_attention_refuses_ragged_chunks():
    q = torch.zeros(1, 48, 2, 8)
    with pytest.raises(AssertionError):
        A.flash_attention(q, q, q, scale=1.0, q_chunk=32, k_chunk=32)


@pytest.mark.parametrize("window", (None, 5))
def test_decode_attention_matches_reference(window):
    B, S, H, K, hd = 2, 16, 4, 2, 8
    q, kc, vc = _randn(0, B, 1, H, hd), _randn(1, B, S, K, hd), _randn(2, B, S, K, hd)
    got = A.decode_attention(as_port(q), as_port(kc), as_port(vc), 9, scale=0.3,
                             window=window)
    want = rj(RA.decode_attention, scale=0.3, window=window)(
        as_ref(q), as_ref(kc), as_ref(vc), jnp.int32(9))
    assert rel(got, want) <= 1e-6


@pytest.mark.parametrize("qk_norm,window", [(False, None), (True, None), (True, 4)])
def test_gqa_prefill_then_decode_matches_reference(qk_norm, window):
    cfg_r = RA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=qk_norm,
                          window=window)
    cfg = A.AttnConfig(d_model=32, n_heads=4, n_kv_heads=2, head_dim=8, qk_norm=qk_norm,
                       window=window)
    rp = rj(RA.gqa_init, cfg=cfg_r)(jax.random.PRNGKey(0))
    if qk_norm:
        rp = {**rp, "q_norm": 1 + 0.1 * jnp.arange(8.0), "k_norm": 1 - 0.05 * jnp.arange(8.0)}
    p = _load(A.GQA(cfg, device="cpu"), rp)
    gqa_r = rj(RA.gqa_apply, cfg=cfg_r, compute_dtype=jnp.float32)
    x = _randn(1, 1, 9, 32)
    full, _ = A.gqa_apply(p, as_port(x), cfg, torch.arange(9), compute_dtype=F32)
    full_r, _ = gqa_r(rp, as_ref(x), positions=jnp.arange(9))
    assert rel(full, full_r) <= 1e-5
    cache = {"k": torch.zeros(1, 16, 2, 8), "v": torch.zeros(1, 16, 2, 8)}
    cache_r = {"k": jnp.zeros((1, 16, 2, 8)), "v": jnp.zeros((1, 16, 2, 8))}
    _, cache = A.gqa_apply(p, as_port(x[:, :8]), cfg, torch.arange(8), cache=cache,
                           cache_pos=0, compute_dtype=F32)
    _, cache_r = gqa_r(rp, as_ref(x[:, :8]), positions=jnp.arange(8), cache=cache_r,
                              cache_pos=jnp.int32(0))
    step, cache = A.gqa_apply(p, as_port(x[:, 8:9]), cfg, torch.tensor([8]), cache=cache,
                              cache_pos=8, compute_dtype=F32)
    step_r, cache_r = gqa_r(rp, as_ref(x[:, 8:9]), positions=jnp.asarray([8]),
                                   cache=cache_r, cache_pos=jnp.int32(8))
    assert rel(step, step_r) <= 1e-5
    assert rel(step[0, 0], full_r[0, 8]) <= 1e-4
    for key in ("k", "v"):
        assert rel(cache[key], cache_r[key]) <= 1e-6


def test_gqa_cross_attention_matches_reference():
    cfg_r = RA.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8)
    cfg = A.AttnConfig(d_model=32, n_heads=4, n_kv_heads=4, head_dim=8)
    rp = rj(RA.gqa_init, cfg=cfg_r)(jax.random.PRNGKey(3))
    p = _load(A.GQA(cfg, device="cpu"), rp)
    x, enc = _randn(0, 2, 3, 32), _randn(1, 2, 10, 32)
    got, _ = A.gqa_apply(p, as_port(x), cfg, torch.arange(4, 7), causal=False,
                         kv_input=as_port(enc), compute_dtype=F32)
    want, _ = rj(RA.gqa_apply, cfg=cfg_r, causal=False, compute_dtype=jnp.float32)(
        rp, as_ref(x), positions=jnp.arange(4, 7), kv_input=as_ref(enc))
    assert rel(got, want) <= 1e-5


def test_mla_prefill_then_decode_matches_reference():
    cfg_r = RA.MLAConfig(d_model=32, n_heads=4, kv_lora=16, rope_dim=8, nope_dim=8, v_dim=8)
    cfg = A.MLAConfig(d_model=32, n_heads=4, kv_lora=16, rope_dim=8, nope_dim=8, v_dim=8)
    rp = rj(RA.mla_init, cfg=cfg_r)(jax.random.PRNGKey(0))
    p = _load(A.MLA(cfg, device="cpu"), rp)
    mla_r = rj(RA.mla_apply, cfg=cfg_r, compute_dtype=jnp.float32)
    x = _randn(2, 2, 9, 32)
    full, _ = A.mla_apply(p, as_port(x), cfg, torch.arange(9), compute_dtype=F32)
    full_r, _ = mla_r(rp, as_ref(x), positions=jnp.arange(9))
    assert rel(full, full_r) <= 1e-5
    cache = {"c_kv": torch.zeros(2, 12, 16), "k_rope": torch.zeros(2, 12, 8)}
    cache_r = {"c_kv": jnp.zeros((2, 12, 16)), "k_rope": jnp.zeros((2, 12, 8))}
    _, cache = A.mla_apply(p, as_port(x[:, :8]), cfg, torch.arange(8), cache=cache,
                           cache_pos=0, compute_dtype=F32)
    _, cache_r = mla_r(rp, as_ref(x[:, :8]), positions=jnp.arange(8), cache=cache_r,
                              cache_pos=jnp.int32(0))
    step, cache = A.mla_apply(p, as_port(x[:, 8:9]), cfg, torch.tensor([8]), cache=cache,
                              cache_pos=8, compute_dtype=F32)
    step_r, cache_r = mla_r(rp, as_ref(x[:, 8:9]), positions=jnp.asarray([8]),
                                   cache=cache_r, cache_pos=jnp.int32(8))
    assert rel(step, step_r) <= 1e-5
    assert rel(step[:, 0], full_r[:, 8]) <= 1e-4
    for key in ("c_kv", "k_rope"):
        assert rel(cache[key], cache_r[key]) <= 1e-6


# --- MoE -----------------------------------------------------------------------


def _moe_pair(cfg_kw: dict, d: int, seed: int = 0):
    rcfg, cfg = RMOE.MoEConfig(**cfg_kw), MOE.MoEConfig(**cfg_kw)
    rp = rj(RMOE.moe_init, d_model=d, cfg=rcfg)(jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, _load(MOE.MoE(d, cfg, device="cpu"), rp)


def _no_topk_ties(p, x, k: int):
    probs = torch.softmax(x.reshape(-1, x.shape[-1]).float() @ p.router.float(), -1)
    top = torch.topk(probs, k + 1, dim=-1).values
    assert bool((top[:, :-1] > top[:, 1:]).all()), "top-k tie: the order is not defined"


@pytest.mark.parametrize("n_shared,groups", [(0, 16), (1, 16), (1, 1)])
def test_moe_ample_capacity_matches_reference(n_shared, groups):
    rcfg, cfg, rp, p = _moe_pair(dict(n_experts=4, top_k=2, d_expert=16, n_shared=n_shared,
                                      capacity_factor=8.0, dispatch_groups=groups), 24)
    x = _randn(1, 2, 8, 24)
    _no_topk_ties(p, as_port(x), 2)
    y, aux = MOE.moe_apply(p, as_port(x), cfg, compute_dtype=F32)
    y_r, aux_r = rj(RMOE.moe_apply, cfg=rcfg, compute_dtype=jnp.float32)(rp, as_ref(x))
    assert rel(y, y_r) <= 1e-5 and float(aux["dropped_frac"]) == 0.0
    assert set(aux) == set(aux_r)
    for key in aux:
        assert float(aux[key]) == pytest.approx(float(aux_r[key]), rel=1e-5, abs=1e-9)


def test_moe_overflow_reproduces_the_slot_c_minus_1_result():
    """Two experts, top-1, capacity 8 for 32 tokens: both overflow.  The
    reference leaves the pad sentinel in slot C - 1 (its duplicate-index
    ``.set`` keeps the last write), so only C - 1 = 7 tokens an expert are
    served, while ``dropped_frac`` counts the positions past C only."""
    rcfg, cfg, rp, p = _moe_pair(dict(n_experts=2, top_k=1, d_expert=8,
                                      capacity_factor=0.25), 16)
    x = _randn(1, 1, 32, 16)
    _no_topk_ties(p, as_port(x), 1)
    y, aux = MOE.moe_apply(p, as_port(x), cfg, compute_dtype=F32)
    y_r, aux_r = rj(RMOE.moe_apply, cfg=rcfg, compute_dtype=jnp.float32)(rp, as_ref(x))
    assert rel(y, y_r) <= 1e-5
    assert float(aux["dropped_frac"]) == pytest.approx(float(aux_r["dropped_frac"]), abs=0)
    C = MOE._capacity(32, cfg)
    expert = torch.argmax(as_port(x)[0] @ p.router, -1)
    served = (y[0].abs().amax(-1) > 0)
    for e in range(2):
        rows = torch.nonzero(expert == e)[:, 0]      # stable order = dispatch order
        assert len(rows) > C
        assert served[rows[:C - 1]].all() and not served[rows[C - 1:]].any()
    assert float(aux["dropped_frac"]) == pytest.approx(1 - 2 * C / 32)
    assert int(served.sum()) == 2 * (C - 1)


def test_moe_bf16_matches_reference_within_bf16():
    rcfg, cfg, rp, p = _moe_pair(dict(n_experts=4, top_k=2, d_expert=16, n_shared=1,
                                      capacity_factor=2.0), 24, seed=2)
    x = _randn(4, 2, 8, 24)
    y, _ = MOE.moe_apply(p, as_port(x).bfloat16(), cfg, compute_dtype=torch.bfloat16)
    y_r, _ = rj(RMOE.moe_apply, cfg=rcfg, compute_dtype=jnp.bfloat16)(
        rp, as_ref(x).astype(jnp.bfloat16))
    assert y.dtype == torch.bfloat16 and rel(y, y_r) <= 2e-2


# --- Mamba-2 -------------------------------------------------------------------


def _ssm_pair(chunk: int, seed: int = 0):
    kw = dict(d_model=32, d_state=8, head_dim=8, expand=2, chunk=chunk)
    rcfg, cfg = RM2.SSMConfig(**kw), M2.SSMConfig(**kw)
    rp = rj(RM2.ssm_init, cfg=rcfg)(jax.random.PRNGKey(seed))
    return rcfg, cfg, rp, _load(M2.SSM(cfg, device="cpu"), rp)


@pytest.mark.parametrize("S", (64, 50))
def test_ssd_chunk_invariance_and_reference(S):
    rcfg32, cfg32, rp, p = _ssm_pair(32)
    _, cfg8, _, _ = _ssm_pair(8)
    x = _randn(1, 2, S, 32)
    y32, _ = M2.ssm_apply(p, as_port(x), cfg32, compute_dtype=F32)
    y8, _ = M2.ssm_apply(p, as_port(x), cfg8, compute_dtype=F32)
    assert float((y32 - y8).abs().max()) <= 2e-4
    y_r, _ = rj(RM2.ssm_apply, cfg=rcfg32, compute_dtype=jnp.float32)(rp, as_ref(x))
    assert rel(y32, y_r) <= 1e-5


def test_ssm_prefill_then_decode_matches_reference():
    rcfg, cfg, rp, p = _ssm_pair(16)
    x = _randn(1, 1, 17, 32)
    y_full, _ = M2.ssm_apply(p, as_port(x), cfg, compute_dtype=F32)
    shapes = M2.ssm_cache_shape(cfg, 1, F32)
    cache = {k: torch.zeros(s.shape, dtype=s.dtype) for k, s in shapes.items()}
    rcache = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype),
                          RM2.ssm_cache_shape(rcfg, 1, jnp.float32))
    _, cache = M2.ssm_apply(p, as_port(x[:, :16]), cfg, cache=cache, compute_dtype=F32)
    _, rcache = rj(RM2.ssm_apply, cfg=rcfg, compute_dtype=jnp.float32)(
        rp, as_ref(x[:, :16]), cache=rcache)
    for key in cache:
        assert rel(cache[key], rcache[key]) <= 1e-5
    step, cache = M2.ssm_apply(p, as_port(x[:, 16:17]), cfg, cache=cache, compute_dtype=F32)
    step_r, rcache = rj(RM2.ssm_apply, cfg=rcfg, compute_dtype=jnp.float32)(
        rp, as_ref(x[:, 16:17]), cache=rcache)
    assert rel(step, step_r) <= 1e-5
    assert float((step[0, 0] - y_full[0, 16]).abs().max()) <= 2e-3 * float(
        y_full[0, 16].abs().max()) + 2e-4
    assert rel(cache["ssm"], rcache["ssm"]) <= 1e-5
