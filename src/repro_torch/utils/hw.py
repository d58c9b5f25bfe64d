"""Hardware constants of the port's target, and the device rule.

``H100`` holds NVIDIA's data-sheet values for the H100 SXM part.  None of
them was measured by this repository: a roofline share computed from them is
a share of the published peak, and a card whose power limit is below 700 W
reaches less (``nvidia-smi --query-gpu=power.limit`` says which card ran).
``ChipSpec.with_bandwidth`` returns the same card with a measured memory
rate (``core.microbench.card_chip`` measures it with the STREAM-triad
kernel), marked ``measured=True``.

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

    def with_bandwidth(self, bytes_per_s: float) -> "ChipSpec":
        """The same chip with a measured memory rate (``measured=True``)."""
        return dataclasses.replace(self, hbm_bytes_per_s=float(bytes_per_s),
                                   measured=True)


#: NVIDIA H100 SXM data sheet (dense rates, 700 W).  Unmeasured.
H100 = ChipSpec(
    name="h100_sxm",
    peak_flops_fp32=67e12,
    peak_flops_fp64=34e12,
    hbm_bytes_per_s=3.35e12,
    measured=False,
)

# The paper's three x86 test systems, kept for the microbenchmark model's
# fidelity: the reference's peak serves as both the f32 and the f64 rate,
# and the memory rate is the paper's measured STREAM Triad (not a data
# sheet, and not measured by this repository).
WOODCREST = ChipSpec("woodcrest", 2 * 4 * 3.0e9, 2 * 4 * 3.0e9, 6.5e9)
SHANGHAI = ChipSpec("shanghai", 8 * 4 * 2.4e9, 8 * 4 * 2.4e9, 20e9)
NEHALEM = ChipSpec("nehalem", 8 * 4 * 2.66e9, 8 * 4 * 2.66e9, 35e9)

CHIPS = {c.name: c for c in (H100, WOODCREST, SHANGHAI, NEHALEM)}


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
