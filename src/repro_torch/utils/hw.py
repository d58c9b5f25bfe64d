"""Hardware constants of the port's target, roofline arithmetic, and the
device rule.

``H100`` holds NVIDIA's data-sheet values for the H100 SXM part.  None of
them was measured by this repository: a roofline share computed from them is
a share of the published peak, and a card whose power limit is below 700 W
reaches less (``nvidia-smi --query-gpu=power.limit`` says which card ran).
``ChipSpec.with_bandwidth`` returns the same card with a measured memory
rate (``core.microbench.card_chip`` measures it with the STREAM-triad
kernel), marked ``measured=True``.

``RooflineTerms`` / ``roofline`` / ``model_flops_per_token`` /
``decode_flops_per_token`` are the reference's (``repro.utils.hw``), priced
on a ``ChipSpec`` (default ``H100``).  One difference: ``mfu_bound`` divides
by the peak of the chip the terms were priced on, where the reference always
divides by its TPU's.

``default_device`` replaces the reference's ``pallas_interpret_default``:
the port runs on the card unless the caller asks for the CPU, and never
falls back to the CPU silently.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class ChipSpec:
    name: str
    peak_flops_fp32: float      # FLOP/s, outside the tensor cores
    peak_flops_fp64: float      # FLOP/s, outside the tensor cores
    hbm_bytes_per_s: float
    measured: bool = False      # False: data-sheet memory rate, not measured here
    peak_flops_bf16: float = 0.0   # FLOP/s, dense bf16 products; 0: the fp32 peak
    hbm_bytes: int = 0             # device memory
    link_bytes_per_s: float = 0.0  # one link, one direction, to another chip
    links: int = 0                 # links of one chip

    def __post_init__(self):
        if not self.peak_flops_bf16:
            object.__setattr__(self, "peak_flops_bf16", self.peak_flops_fp32)

    def with_bandwidth(self, bytes_per_s: float) -> "ChipSpec":
        """The same chip with a measured memory rate (``measured=True``)."""
        return dataclasses.replace(self, hbm_bytes_per_s=float(bytes_per_s),
                                   measured=True)


#: NVIDIA H100 SXM data sheet (dense rates, 700 W).  Unmeasured.  NVLink 4:
#: 18 links, 450 GB/s each way in all, so 25 GB/s a link each way.
H100 = ChipSpec(
    name="h100_sxm",
    peak_flops_fp32=67e12,
    peak_flops_fp64=34e12,
    hbm_bytes_per_s=3.35e12,
    measured=False,
    peak_flops_bf16=989e12,
    hbm_bytes=80 * 10**9,
    link_bytes_per_s=450e9 / 18,
    links=18,
)

# The paper's three x86 test systems, kept for the microbenchmark model's
# fidelity: the reference's peak serves as the f32, f64 and bf16 rate, and
# the memory rate is the paper's measured STREAM Triad (not a data sheet,
# and not measured by this repository).  No links, as in the reference.
WOODCREST = ChipSpec("woodcrest", 2 * 4 * 3.0e9, 2 * 4 * 3.0e9, 6.5e9,
                     hbm_bytes=8 * 1024**3)
SHANGHAI = ChipSpec("shanghai", 8 * 4 * 2.4e9, 8 * 4 * 2.4e9, 20e9,
                    hbm_bytes=16 * 1024**3)
NEHALEM = ChipSpec("nehalem", 8 * 4 * 2.66e9, 8 * 4 * 2.66e9, 35e9,
                   hbm_bytes=24 * 1024**3)

CHIPS = {c.name: c for c in (H100, WOODCREST, SHANGHAI, NEHALEM)}


@dataclass(frozen=True)
class RooflineTerms:
    """The three roofline times (seconds) for one program on ``chips`` chips
    of bf16 peak ``peak_flops_bf16``."""

    compute_s: float
    memory_s: float
    collective_s: float
    chips: int
    flops: float
    bytes_hbm: float
    bytes_collective: float
    peak_flops_bf16: float = H100.peak_flops_bf16

    @property
    def bound(self) -> str:
        terms = {
            "compute": self.compute_s,
            "memory": self.memory_s,
            "collective": self.collective_s,
        }
        return max(terms, key=terms.get)

    @property
    def critical_s(self) -> float:
        """Lower-bound step time if the three resources overlap perfectly."""
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def serial_s(self) -> float:
        """Upper-bound step time with zero overlap."""
        return self.compute_s + self.memory_s + self.collective_s

    def mfu_bound(self, model_flops: float) -> float:
        """Max achievable MFU given the roofline (the critical path), as a
        share of the priced chip's peak."""
        if self.critical_s == 0:
            return 0.0
        achievable = model_flops / self.critical_s
        return achievable / (self.chips * self.peak_flops_bf16)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["bound"] = self.bound
        d["critical_s"] = self.critical_s
        return d


def roofline(
    flops: float,
    bytes_hbm: float,
    bytes_collective: float,
    chips: int,
    chip: ChipSpec = H100,
    collective_links: int | None = None,
) -> RooflineTerms:
    """Three-term roofline:

    compute    = FLOPs / (chips * bf16 peak)
    memory     = HBM bytes / (chips * HBM rate)
    collective = collective bytes / (chips * link rate * links credited)

    ``flops`` / ``bytes`` are global (all chips) quantities.
    ``collective_links`` credits several links (default one)."""
    links = 1 if collective_links is None else collective_links
    return RooflineTerms(
        compute_s=flops / (chips * chip.peak_flops_bf16),
        memory_s=bytes_hbm / (chips * chip.hbm_bytes_per_s),
        collective_s=bytes_collective / (chips * chip.link_bytes_per_s * links),
        chips=chips,
        flops=flops,
        bytes_hbm=bytes_hbm,
        bytes_collective=bytes_collective,
        peak_flops_bf16=chip.peak_flops_bf16,
    )


def model_flops_per_token(n_params_active: float) -> float:
    """The standard 6N approximation (fwd 2N + bwd 4N) per token."""
    return 6.0 * n_params_active


def decode_flops_per_token(n_params_active: float) -> float:
    """Forward-only: 2N per generated token."""
    return 2.0 * n_params_active


def default_device(device=None) -> torch.device:
    """The device an entry point runs on.

    ``device=None`` means the card: ``cuda`` when CUDA is available, and a
    ``RuntimeError`` otherwise -- a run that asked for the card must not
    quietly measure the host.  Any explicit device (``"cpu"``,
    ``"cuda:1"``, a ``torch.device``) is returned as a ``torch.device``; a
    CUDA device always carries its index, so devices compare equal to the
    ones tensors report.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: repro_torch entry points run on the card by "
            "default; pass device='cpu' to run the plain PyTorch kernels "
            "on the host")
    return dev if dev.index is not None else torch.device(
        "cuda", torch.cuda.current_device())


def synchronize(device) -> None:
    """Wait for the work queued on ``device`` (a no-op off CUDA): eager
    PyTorch returns before the card finishes."""
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
