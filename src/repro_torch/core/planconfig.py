"""PlanConfig: the compile-time configuration record of an SpMV plan.

The reference's record, cut to the options the port carries, plus the
``device`` the plan runs on:

* ``format`` -- None plans the container as it is; a name ("csr", "ell",
  "jds", "sell", "bsr", "dia", "hybrid", "matrix_free") converts a CSR/COO
  source first (bsr in (8, 128) blocks); ``"auto"`` lets
  ``perfmodel.select_format`` pick (with an autotuned SELL sigma).
* ``value_dtype`` -- value-storage precision (f64, f32, bf16, f16,
  fp8_e4m3, int8); kernels accumulate in >= f32.
* ``chip`` / ``am`` -- the roofline parameters (default: the H100 data
  sheet; ``core.microbench.card_chip()`` is the card with its measured
  bandwidth) and the access model (None: byte widths from the stored
  dtype).
* ``backend`` -- "auto" | "cuda" | "torch" | "loop_reference".
* ``sigma`` / ``permute`` -- the SELL-C-sigma sorting window; None keeps the
  default window (and autotunes under ``format="auto"``), ``permute=False``
  forces the identity row order.
* ``device`` -- None means the card (and raises without one); "cpu" runs
  the plain PyTorch kernels on the host.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

from ..utils.hw import H100, ChipSpec


@dataclass(frozen=True)
class PlanConfig:
    format: str | None = None
    value_dtype: str | None = None
    chip: ChipSpec = H100
    am: object | None = None         # perfmodel.AccessModel
    backend: str = "auto"
    sigma: int | None = None
    permute: bool = True
    device: object = None            # None = the card; "cpu" = the host

    def replace(self, **kw) -> "PlanConfig":
        return dataclasses.replace(self, **kw)

    def sell_kwargs(self) -> dict:
        """Conversion kwargs expressing the sigma request (empty for the
        default, so cached conversions stay those of the plain packer)."""
        if self.permute and self.sigma is None:
            return {}
        return {"sigma": 1 if not self.permute else max(1, int(self.sigma))}
