"""Generated electron x phonon SpMV: the Holstein-Hubbard Hamiltonian from
its model's tables (``core.formats.ElectronPhononOperator``), no entry
stored.

Row ``e * P + p`` (electron state e, phonon state p) sums, in this order:
the diagonal ``(U docc(e) + omega0 sum n(p)) x[eP + p]``; site by site the
phonon raised and lowered, ``(g omega0 n_i(e)) sqrt(n_i(p) + 1) x[eP +
up_i(p)]`` and ``... sqrt(n_i(p)) x[eP + dn_i(p)]``; then each hop of e,
``v_h x[t_h P + p]``.  A ladder step outside the basis (rank -1), a zero
coupling or a padded hop adds +0.0.

``mf_product_arrays`` launches ``csrc/mf_product.cu`` on a CUDA tensor and
runs ``mf_product_plain`` on a CPU tensor; both follow the order above, so
they give equal values (the kernel skips a zero coupling and the hop
padding for a whole electron state, where the plain version adds +0.0).
The kernel takes the operator only as a ``ProductLaunch``: its tables
derived and checked on the host once per operator (couplings, a 32-byte
ladder record a phonon state, a sqrt(n) table; at most ``MAX_SITES``
sites), copied to a card once.  Registry entries: ``(mf_product, {spmv,
spmm}, {torch, loop_reference})`` and ``(mf_product, spmv, cuda)``: an
SpMM runs the composite entry on the card too.
"""
from __future__ import annotations

import ctypes
import math

import numpy as np
import torch

from ..core.formats import ElectronPhononOperator
from ..utils.spans import span
from . import cuda_build as CB
from .cache import cached, register_stat, spmm_by_columns
from .registry import CompiledKernel, KernelContext, register_kernel

NAME = "mf_product"
_ARGTYPES = ([ctypes.c_void_p] * 6 + [ctypes.c_double] + [ctypes.c_int] * 4
             + [ctypes.c_void_p] * 3)

#: sites a phonon record holds (``kSites`` in csrc/mf_product.cu)
MAX_SITES = 6
#: entries of the kernel's sqrt(n) table (``kSqrt``): occupations below 31
SQRT_TABLE = 32
#: phonon ranks are 16-bit on the card, 0xFFFF meaning none (``kNone``);
#: the grid's second dimension is one electron state a block
MAX_PHONON_STATES = 0xFFFF
MAX_ELECTRON_STATES = 65535
#: 32-bit words of a phonon state's record (``PhRecord``): words 0-5 site
#: i's up rank | down rank << 16, words 6-7 the occupations, a byte each
RECORD_WORDS = 8

register_stat("mf_product_launch")


def product_tables(op: ElectronPhononOperator) -> dict:
    """The tensors both the kernel and the plain version read, on the host:
    ``el_diag`` (n_el,), ``el_coup`` (n_el, L) = g omega0 n_i(e),
    ``hop_target`` / ``hop_value`` (n_el, H), ``ph_energy`` (n_ph,) = omega0
    sum n(p), and site-major (L, n_ph) ``ph_up`` / ``ph_dn`` ranks with
    their ``sq_up`` / ``sq_dn`` square roots (0 where the rank is -1)."""
    occ = op.ph_occ.numpy().astype(np.float64)
    up, dn = op.ph_up.numpy(), op.ph_dn.numpy()
    sq_up = np.where(up >= 0, np.sqrt(occ + 1.0), 0.0)
    sq_dn = np.where(dn >= 0, np.sqrt(occ), 0.0)
    site_major = lambda a: torch.from_numpy(np.ascontiguousarray(a.T))  # noqa: E731
    return {
        "el_diag": op.el_diag.to(torch.float64).contiguous(),
        "el_coup": torch.from_numpy((op.g * op.omega0)
                                    * op.el_occ.numpy().astype(np.float64)),
        "hop_target": op.hop_target.to(torch.int32).contiguous(),
        "hop_value": op.hop_value.to(torch.float64).contiguous(),
        "ph_energy": torch.from_numpy(op.omega0 * occ.sum(axis=1)),
        "ph_up": site_major(up.astype(np.int32)), "ph_dn": site_major(dn.astype(np.int32)),
        "sq_up": site_major(sq_up), "sq_dn": site_major(sq_dn),
    }


def phonon_records(op: ElectronPhononOperator) -> np.ndarray:
    """The kernel's (n_ph, ``RECORD_WORDS``) uint32 records: word i (i <
    L) is site i's up rank | down rank << 16 (0xFFFF for none), words 6-7
    the occupations, site i in byte i % 4 of word 6 + i // 4."""
    L = op.n_sites
    rank16 = lambda r: np.where(r >= 0, r, 0xFFFF).astype(np.uint32)  # noqa: E731
    rec = np.zeros((op.n_ph, RECORD_WORDS), np.uint32)
    rec[:, :L] = rank16(op.ph_up.numpy()) | (rank16(op.ph_dn.numpy()) << 16)
    occ = op.ph_occ.numpy().astype(np.uint32)
    for i in range(L):
        rec[:, 6 + i // 4] |= occ[:, i] << (8 * (i % 4))
    return rec


def kernel_tables(op: ElectronPhononOperator) -> dict:
    """What the kernel reads besides x: the electron tables of
    ``product_tables``, the ``phonon_records`` (an int32 tensor holding the
    uint32 bits) and ``sqrt_n`` = sqrt(n) for n < ``SQRT_TABLE``."""
    t = product_tables(op)
    return {"el_diag": t["el_diag"], "el_coup": t["el_coup"], "hop_target": t["hop_target"],
            "hop_value": t["hop_value"],
            "ph_record": torch.from_numpy(phonon_records(op).view(np.int32)),
            "sqrt_n": torch.from_numpy(np.sqrt(np.arange(SQRT_TABLE, dtype=np.float64)))}


def mf_product_plain(t: dict, x: torch.Tensor) -> torch.Tensor:
    """The composite form over ``product_tables`` (on x's device): gathers
    from the (n_el, n_ph) view of x (a vector, or an (N, K) block) and a sum
    in the kernel's order; f64."""
    n_el, n_ph = t["el_diag"].shape[0], t["ph_energy"].shape[0]
    X = x.to(torch.float64).reshape(n_el, n_ph, -1)
    zero = torch.zeros((), dtype=torch.float64, device=X.device)
    d = (t["el_diag"][:, None] + t["ph_energy"][None, :])[..., None]
    acc = torch.where(d != 0, d * X, zero)
    for i in range(t["ph_up"].shape[0]):
        c = t["el_coup"][:, i, None, None]
        for rank, sq in ((t["ph_up"][i], t["sq_up"][i]), (t["ph_dn"][i], t["sq_dn"][i])):
            ok = (c != 0) & (rank >= 0)[None, :, None]
            xs = X[:, rank.clamp(min=0).long()]
            acc = acc + torch.where(ok, (c * sq[None, :, None]) * xs, zero)
    for h in range(t["hop_target"].shape[1]):
        tgt = t["hop_target"][:, h]
        xs = X[tgt.clamp(min=0).long()]
        acc = acc + torch.where((tgt >= 0)[:, None, None],
                                t["hop_value"][:, h, None, None] * xs, zero)
    return acc.reshape(x.shape)


class ProductLaunch:
    """The kernel's view of one operator: ``product_tables`` for the plain
    version and ``kernel_tables``, checked on the host once (at most
    ``MAX_SITES`` sites, fewer than ``MAX_PHONON_STATES`` phonon states and
    ``MAX_ELECTRON_STATES`` electron states, occupations below
    ``SQRT_TABLE - 1``).  ``on(device)`` copies the kernel's tables to a
    card once.  ``mf_product_arrays`` takes the
    operator in no other form."""

    def __init__(self, op: ElectronPhononOperator):
        if not isinstance(op, ElectronPhononOperator):
            raise TypeError(f"ProductLaunch: expected an ElectronPhononOperator, got "
                            f"{type(op).__name__}")
        if not 1 <= op.n_sites <= MAX_SITES:
            raise ValueError(f"mf_product: {op.n_sites} sites; the kernel holds 1 to "
                             f"{MAX_SITES}")
        if op.n_ph >= MAX_PHONON_STATES:
            raise ValueError(f"mf_product: {op.n_ph} phonon states; the kernel's 16-bit "
                             f"ranks take fewer than {MAX_PHONON_STATES}")
        if op.n_ph and int(op.ph_occ.max()) >= SQRT_TABLE - 1:
            raise ValueError(f"mf_product: {int(op.ph_occ.max())} phonons on a site; the "
                             f"kernel's sqrt table takes fewer than {SQRT_TABLE - 1}")
        if op.n_el > MAX_ELECTRON_STATES:
            raise ValueError(f"mf_product: {op.n_el} electron states; the grid takes "
                             f"{MAX_ELECTRON_STATES}")
        self.shape = op.shape
        self.n_el, self.n_ph, self.n_sites = op.n_el, op.n_ph, op.n_sites
        self.n_hops = int(op.hop_target.shape[1])
        self.omega0 = float(op.omega0)
        self.tables = product_tables(op)
        self.kernel = kernel_tables(op)
        self._on: dict = {}

    def on(self, device) -> dict:
        """The kernel's tables on ``device``, copied there once."""
        key = str(torch.device(device))
        if key not in self._on:
            self._on[key] = {k: v.to(device) for k, v in self.kernel.items()}
        return self._on[key]


def product_launch(op: ElectronPhononOperator) -> ProductLaunch:
    """The operator's ``ProductLaunch``, built once per container."""
    return cached(op, "_mp_launch", "mf_product_launch", lambda: ProductLaunch(op))


def mf_product_arrays(launch: ProductLaunch, x: torch.Tensor) -> torch.Tensor:
    """y = H x (f64) for the operator ``launch`` describes: the CUDA kernel
    for a CUDA ``x`` (cast to f64 where it is not), the plain version for a
    CPU one."""
    if not isinstance(launch, ProductLaunch):
        raise TypeError(f"mf_product: the operator must come as a ProductLaunch "
                        f"(product_launch(op)), got {type(launch).__name__}")
    n = launch.shape[0]
    if tuple(x.shape) != (n,):
        raise ValueError(f"mf_product: x has shape {tuple(x.shape)}, the operator has "
                         f"{n} columns")
    if x.device.type == "cpu":
        return mf_product_plain(launch.tables, x)
    if x.device.type != "cuda":
        raise ValueError(f"mf_product: no kernel for device {x.device}")
    dev = x.device
    with span("kernel.check"):
        if x.dtype != torch.float64:
            x = x.to(torch.float64)
        if not x.is_contiguous():
            x = x.contiguous()
    t = launch.on(dev)
    y = torch.empty(n, dtype=torch.float64, device=dev)
    CB.launch(NAME, _ARGTYPES, dev, CB.ptr(t["el_diag"]), CB.ptr(t["el_coup"]),
              CB.ptr(t["hop_target"]), CB.ptr(t["hop_value"]), CB.ptr(t["ph_record"]),
              CB.ptr(t["sqrt_n"]), launch.omega0, launch.n_el, launch.n_ph, launch.n_sites,
              launch.n_hops, CB.ptr(x), CB.ptr(y))
    return y


def mf_product_loop(op: ElectronPhononOperator, ctx: KernelContext):
    """The oracle: row by row in Python from the operator's own fields, each
    value computed from the model as the CSR builder computes it."""
    n_el, n_ph, L = op.n_el, op.n_ph, op.n_sites
    hop_t, hop_v = op.hop_target.tolist(), op.hop_value.tolist()
    el_diag, el_occ = op.el_diag.tolist(), op.el_occ.tolist()
    ph_occ, ph_up, ph_dn = op.ph_occ.tolist(), op.ph_up.tolist(), op.ph_dn.tolist()
    amp = op.g * op.omega0

    def fn(x):
        xs = x.detach().to("cpu", torch.float64).tolist()
        y = []
        for e in range(n_el):
            b = e * n_ph
            for p in range(n_ph):
                s = (el_diag[e] + op.omega0 * sum(ph_occ[p])) * xs[b + p]
                for i in range(L):
                    c = amp * el_occ[e][i]
                    if c == 0.0:
                        continue
                    if ph_up[p][i] >= 0:
                        s += c * math.sqrt(ph_occ[p][i] + 1) * xs[b + ph_up[p][i]]
                    if ph_dn[p][i] >= 0:
                        s += c * math.sqrt(ph_occ[p][i]) * xs[b + ph_dn[p][i]]
                for tgt, v in zip(hop_t[e], hop_v[e]):
                    if tgt >= 0:
                        s += v * xs[tgt * n_ph + p]
                y.append(s)
        return torch.tensor(y, dtype=torch.float64, device=x.device)

    return fn


def _plain_executor(op: ElectronPhononOperator, ctx: KernelContext):
    """x -> the plain version, the tables on the plan's device from compile on."""
    tables = {k: v.to(ctx.device) for k, v in product_launch(op).tables.items()}
    return lambda x: mf_product_plain(tables, x)


def _cuda_executor(op: ElectronPhononOperator, ctx: KernelContext):
    """x -> the kernel, the tables on the card from plan compile on."""
    launch = product_launch(op)
    launch.on(ctx.device)
    return lambda x: mf_product_arrays(launch, x)


@register_kernel("mf_product", "spmv", "torch",
                 description="electron x phonon tables: gathers + sum, kernel order")
def _build_spmv(op: ElectronPhononOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_plain_executor(op, ctx), "torch")


@register_kernel("mf_product", "spmm", "torch",
                 description="multi-vector gathers + sum over the (n_el, n_ph) view")
def _build_spmm(op: ElectronPhononOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_plain_executor(op, ctx), "torch")


@register_kernel("mf_product", "spmv", "loop_reference",
                 description="row-by-row oracle, values from the model")
def _build_spmv_loop(op: ElectronPhononOperator, ctx) -> CompiledKernel:
    return CompiledKernel(mf_product_loop(op, ctx), "loop")


@register_kernel("mf_product", "spmm", "loop_reference",
                 description="column-by-column row oracles")
def _build_spmm_loop(op: ElectronPhononOperator, ctx) -> CompiledKernel:
    return CompiledKernel(spmm_by_columns(mf_product_loop(op, ctx)), "loop")


@register_kernel("mf_product", "spmv", "cuda",
                 description="phonon ranks a warp, electron tables shared by the block")
def _build_spmv_cuda(op: ElectronPhononOperator, ctx) -> CompiledKernel:
    return CompiledKernel(_cuda_executor(op, ctx), "cuda")

