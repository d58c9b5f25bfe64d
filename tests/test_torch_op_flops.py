"""The port's op counter (``repro_torch.utils.op_flops``, counterpart of
``repro.utils.jaxpr_flops``) and collective census
(``repro_torch.utils.collectives``, counterpart of ``repro.utils.hlo``).

* ``tests/test_infra.py``'s three ``jaxpr_flops`` tests, restated for
  ``flops_of_fn`` on ``meta`` tensors.
* Each reduced architecture's loss on ``meta``, forward and forward plus
  backward: the products' FLOPs equal the reference's ``dot_general`` count
  (a walk of ``jax.make_jaxpr(...).jaxpr`` with
  ``repro.utils.jaxpr_flops._dot_flops``) exactly -- except the backward of
  a Mamba-2 layer, pinned below with its cause -- and every FLOP counted
  (products and the rest) within 3 % of the reference's ``count_jaxpr``
  (the two programs split their elementwise work into different ops: one
  ``_softmax`` here, five primitives there).
* ``CollectiveStats.summary()`` / ``effective_link_bytes`` against the
  reference's on the same collectives, and ``count_collectives`` on a gloo
  group of one process and on the ``fake`` backend at world size 16.
"""
import datetime
import sys

import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from _torch_lm import ARCHS, configs  # noqa: E402
from repro.models.registry import Model as RModel  # noqa: E402
from repro.utils import hlo as RH  # noqa: E402
from repro.utils import jaxpr_flops as RJ  # noqa: E402
from repro_torch.models.registry import Model as PModel  # noqa: E402
from repro_torch.utils import collectives as PC  # noqa: E402
from repro_torch.utils.op_flops import OpCounter, count_fn, flops_of_fn  # noqa: E402

META = torch.device("meta")
#: |port total / reference total - 1|: the elementwise split differs
TOTAL_TOL = 0.03
B, S = 2, 64


def _m(*shape, grad=False):
    return torch.empty(shape, device=META, requires_grad=grad)


# --- tests/test_infra.py's jaxpr_flops tests, restated ----------------------


def test_flops_of_fn_matmul_exact():
    assert flops_of_fn(lambda a, b: a @ b, _m(64, 128), _m(128, 32)) == 2 * 64 * 128 * 32


def test_flops_of_fn_loop_multiplies():
    """The reference needs a scan rule (length x body); the port counts the
    iterations because they run."""
    def f(x, ws):
        for w in ws:
            x = x @ w
        return x
    fl = flops_of_fn(f, _m(8, 16), _m(5, 16, 16))
    assert fl >= 5 * 2 * 8 * 16 * 16
    assert count_fn(f, _m(8, 16), _m(5, 16, 16)).matmul == 5 * 2 * 8 * 16 * 16


def test_flops_of_fn_remat_counts_recompute():
    """A checkpointed region is run again in the backward, inside the mode:
    fwd + recompute + 2 backward products (w and x both need grads)."""
    from torch.utils.checkpoint import checkpoint

    def loss(w, x, remat=True):
        f = lambda x, w: torch.tanh(x @ w)  # noqa: E731
        y = checkpoint(f, x, w, use_reentrant=False) if remat else f(x, w)
        return y.sum()

    def grad(w, x, remat=True):
        torch.autograd.grad(loss(w, x, remat), (w, x))

    w, x = _m(32, 32, grad=True), _m(8, 32, grad=True)
    fwd = flops_of_fn(loss, w, x)
    bwd = flops_of_fn(grad, w, x)
    assert 3.0 < bwd / fwd < 5.0
    mm = 2 * 8 * 32 * 32
    assert count_fn(grad, w, x).matmul == 4 * mm
    assert count_fn(grad, w, x).matmul - count_fn(grad, w, x, False).matmul == mm


# --- the counter's own bookkeeping -------------------------------------------


def test_bytes_and_views():
    a, b = torch.ones(4, 8), torch.ones(4, 8)
    c = count_fn(lambda: (a + b).t()[None])
    assert c.other == 32 and c.matmul == 0
    assert c.bytes == 3 * 4 * 8 * 4                 # two reads and one write; views move none
    assert c.by_op["add"][:1] == [1]


def test_foreach_and_in_place_ops_count_their_outputs():
    ts = [torch.ones(3), torch.ones(5)]
    c = count_fn(lambda: torch._foreach_mul_(ts, 2.0))
    assert c.other == 8
    c = count_fn(lambda: ts[0].add_(1.0))
    assert c.other == 3


def test_free_ops_cost_no_flops():
    x = torch.arange(12.0).reshape(3, 4)
    idx = torch.tensor([2, 0])
    c = count_fn(lambda: (x.index_select(0, idx), x.to(torch.float64), x == 1.0,
                          torch.cat([x, x]), x.clone()))
    assert c.flops == 0 and c.bytes > 0


def test_counted_kernel_launch_marks_missing_work():
    from repro_torch.kernels import cuda_build as CB
    with OpCounter() as oc:
        CB.count_launch("sell_spmv")
    assert oc.counts.launches == 1 and not oc.counts.complete
    assert count_fn(lambda: torch.ones(2) * 2).complete


def test_counts_are_exact_integers_past_2_53():
    a, b = _m(1 << 22, 1 << 16), _m(1 << 16, 1 << 16)
    c = count_fn(lambda: a @ b)
    assert c.matmul == 2 * (1 << 22) * (1 << 16) * (1 << 16)
    assert isinstance(c.matmul, int) and c.matmul > 2 ** 53


# --- each reduced architecture against the reference's jaxpr ----------------


def _ref_dots(jaxpr) -> int:
    """dot_general FLOPs of a jaxpr, recursing as ``count_jaxpr`` does."""
    tot = 0
    for e in jaxpr.eqns:
        name = e.primitive.name
        if name == "dot_general":
            tot += int(RJ._dot_flops(e))
        elif name == "scan":
            tot += e.params["length"] * _ref_dots(e.params["jaxpr"].jaxpr)
        elif name == "cond":
            tot += max(_ref_dots(b.jaxpr) for b in e.params["branches"])
        else:
            sub = (e.params.get("jaxpr") or e.params.get("call_jaxpr")
                   or e.params.get("fun_jaxpr"))
            if sub is not None:
                tot += _ref_dots(sub.jaxpr if hasattr(sub, "jaxpr") else sub)
    return tot


_REF: dict = {}


def _reference(arch: str) -> dict:
    """The reference's dot_general FLOPs and count_jaxpr totals of the
    reduced loss, forward and forward plus backward (jax.grad)."""
    if arch not in _REF:
        rc, _ = configs(arch)
        rm = RModel(rc)
        batch = _batch_specs(rc)
        fj = jax.make_jaxpr(lambda p, b: rm.loss(p, b)[0])(rm.param_shapes(), batch).jaxpr
        bj = jax.make_jaxpr(lambda p, b: jax.grad(lambda q: rm.loss(q, b)[0])(p))(
            rm.param_shapes(), batch).jaxpr
        _REF[arch] = {"fwd": (_ref_dots(fj), RJ.count_jaxpr(fj)),
                      "bwd": (_ref_dots(bj), RJ.count_jaxpr(bj))}
    return _REF[arch]


def _batch_specs(rc) -> dict:
    sds = jax.ShapeDtypeStruct
    if rc.family == "encdec":
        batch = {"enc_embeds": sds((B, S, rc.d_model), jnp.bfloat16),
                 "tokens": sds((B, S), jnp.int32)}
    elif rc.input_mode == "embeds":
        batch = {"embeds": sds((B, S, rc.d_model), jnp.bfloat16)}
    else:
        batch = {"tokens": sds((B, S), jnp.int32)}
    return {**batch, "labels": sds((B, S), jnp.int32)}


def _port_counts(arch: str, backward: bool):
    _, pc = configs(arch)
    pm = PModel(pc)
    params = pm.build(META)
    batch = {k: torch.empty(v.shape, dtype=getattr(torch, str(v.dtype)), device=META)
             for k, v in _batch_specs(configs(arch)[0]).items()}

    def run():
        loss, _ = pm.loss(params, batch)
        if backward:
            torch.autograd.grad(loss, list(params.parameters()), allow_unused=True)

    return pc, count_fn(run)


def _ssm_backward_gap(pc) -> int:
    """Products the reference's scan differentiates and torch autograd does
    not, in the backward of each Mamba-2 layer.  The reference runs the SSD
    chunks as a ``lax.scan`` whose carry (the state h) is differentiated
    whole: (1) it computes the cotangent of the initial state, a zeros
    constant (``einsum("bqn,bhdn->bqhd", C, h)`` transposed to h: one
    product); (2) it pushes the final state's zero cotangent -- the loss
    does not read h_fin -- back through the last chunk's state update
    (``einsum("bqn,bqhd->bhdn", B, x)`` transposed to both operands: two
    products).  Autograd computes gradients only toward tensors that need
    them and only from tensors the loss reaches, so the port runs neither:
    3 products of 2 * B * Q * H * hd * N a layer, whatever the chunk count."""
    if pc.ssm is None:
        return 0
    s = pc.ssm
    n_ssm = pc.n_layers if pc.family == "ssm" else pc.n_layers - pc.n_layers // pc.hybrid_period
    q = min(s.chunk, S)
    return n_ssm * 3 * 2 * B * q * s.n_heads * s.head_dim * s.d_state


@pytest.mark.parametrize("backward", (False, True), ids=("fwd", "fwd_bwd"))
@pytest.mark.parametrize("arch", ARCHS)
def test_reduced_arch_products_match_reference(arch, backward):
    ref_mm, ref_total = _reference(arch)["bwd" if backward else "fwd"]
    pc, c = _port_counts(arch, backward)
    gap = _ssm_backward_gap(pc) if backward else 0
    assert c.matmul == ref_mm - gap
    if arch == "qwen3-0.6b":
        assert gap == 0 and c.matmul == ref_mm
    if arch in ("mamba2-2.7b", "jamba-1.5-large-398b") and backward:
        assert gap > 0                              # pinned, not padded
    assert c.complete and c.launches == 0
    assert abs(c.flops / ref_total - 1) <= TOTAL_TOL


# --- collectives -------------------------------------------------------------


def _port_stats():
    """The census of one op of each kind, as ``count_collectives`` records
    them at world size 16: all-gather (4, 8) -> (64, 8), all-reduce (64,),
    reduce-scatter (64, 8) -> (4, 8), all-to-all (16, 4); f32."""
    st = PC.CollectiveStats()
    st.record("all-gather", 64 * 8 * 4, "all_gather_into_tensor")
    st.record("all-reduce", 64 * 4, "all_reduce")
    st.record("reduce-scatter", 64 * 8 * 4, "reduce_scatter_tensor")
    st.record("all-to-all", 16 * 4 * 4, "all_to_all_single")
    return st


_HLO = """
  %ag = f32[64,8] all-gather(f32[4,8] %x), replica_groups={}
  %ar = f32[64] all-reduce(f32[64] %y), to_apply=%add
  %rs = f32[4,8] reduce-scatter(f32[64,8] %z), dimensions={0}
  %a2a = f32[16,4] all-to-all(f32[16,4] %w), dimensions={0}
"""


def test_summary_matches_reference():
    """Equal on every key but the reduce-scatter's bytes: the reference's
    docstring counts its input (the buffer the ring moves), its code the
    result signature, 1/16 of it here.  The port counts the input."""
    ref = RH.parse_collectives(_HLO).summary()
    port = _port_stats().summary()
    assert set(port) == set(ref)
    assert port["reduce-scatter_bytes"] == 16 * ref["reduce-scatter_bytes"]
    diff = {k for k in ref if port[k] != ref[k]}
    assert diff == {"reduce-scatter_bytes", "total_bytes"}
    assert port["total_bytes"] - ref["total_bytes"] == 15 * ref["reduce-scatter_bytes"]


@pytest.mark.parametrize("axes", (None, {"data": 16}, {"data": 16, "model": 16}, {"d": 1}))
def test_effective_link_bytes_matches_reference(axes):
    ref = RH.parse_collectives(_HLO)
    port = _port_stats()
    port.bytes_by_kind["reduce-scatter"] = ref.bytes_by_kind["reduce-scatter"]
    assert PC.effective_link_bytes(port, axes) == RH.effective_link_bytes(ref, axes)


def test_shape_bytes_matches_reference():
    for dt, shape, lit in ((torch.float32, (128, 1024), "f32[128,1024]"),
                           (torch.bfloat16, (2, 16), "bf16[2,16]"),
                           (torch.float32, (), "f32[]"), (torch.bool, (7,), "pred[7]"),
                           (torch.float8_e4m3fn, (3, 5), "f8e4m3fn[3,5]")):
        assert PC.shape_bytes(dt, shape) == RH.shape_bytes(lit)


@pytest.fixture
def gloo_world1():
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    yield dist.group.WORLD
    dist.destroy_process_group()


@pytest.fixture
def fake_world16():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=16,
                            timeout=datetime.timedelta(seconds=60))
    yield dist.group.WORLD
    dist.destroy_process_group()


def _wait(t):
    return torch.ops._c10d_functional.wait_tensor(t)


def test_count_collectives_sees_all_reduce_on_gloo(gloo_world1):
    import torch.distributed._functional_collectives as fc
    x = torch.ones(64)
    st = PC.count_collectives(lambda: _wait(fc.all_reduce(x, "sum", gloo_world1)))
    assert st.count_by_kind["all-reduce"] == 1 and st.total_count == 1
    assert st.bytes_by_kind["all-reduce"] == 64 * 4
    assert PC.count_op(st, "all-reduce") == 1 and PC.count_op(st, "all_reduce") == 1


def test_count_collectives_on_the_fake_backend(fake_world16):
    import torch.distributed._functional_collectives as fc
    x = torch.ones(4, 8)

    def step():
        g = _wait(fc.all_gather_tensor(x, 0, fake_world16))
        r = _wait(fc.reduce_scatter_tensor(g, "sum", 0, fake_world16))
        return _wait(fc.all_reduce(r, "sum", fake_world16))

    st = PC.count_collectives(step)
    assert st.bytes_by_kind["all-gather"] == 64 * 8 * 4          # the output
    assert st.bytes_by_kind["reduce-scatter"] == 64 * 8 * 4      # the input
    assert st.bytes_by_kind["all-reduce"] == 4 * 8 * 4
    assert st.total_count == 3 and PC.count_op(st, "all-gather") == 1
    summary = st.summary()
    assert summary["total_bytes"] == st.total_bytes and summary["all-gather_count"] == 1


def test_modules_import_neither_jax_nor_repro():
    import subprocess
    code = ("import sys; import repro_torch.utils.op_flops, repro_torch.utils.collectives, "
            "repro_torch.launch.dryrun, repro_torch.launch.roofline, "
            "repro_torch.launch.hillclimb; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith(('jax.', 'repro.'))"
            " or m == 'repro']; print(bad); sys.exit(1 if bad else 0)")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
