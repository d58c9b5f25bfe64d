"""PlanConfig: the compile-time configuration record of an SpMV plan.

The reference's record, cut to the options this slice carries, plus the
``device`` the plan runs on:

* ``format`` -- None plans the container as it is; a name ("csr", "sell",
  "dia", "hybrid", "matrix_free") converts a CSR/COO source first.
  ``"auto"`` (the cost-model pick) belongs to the perfmodel slice and
  raises here.
* ``value_dtype`` -- value-storage precision (f64, f32, bf16, f16,
  fp8_e4m3, int8); kernels accumulate in >= f32.
* ``backend`` -- "auto" | "cuda" | "torch" | "loop_reference".
* ``sigma`` / ``permute`` -- the SELL-C-sigma sorting window; None keeps the
  default window, ``permute=False`` forces the identity row order.
* ``device`` -- None means the card (and raises without one); "cpu" runs
  the plain PyTorch kernels on the host.
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass

#: where format="auto" will come from
AUTO_FORMAT_SLICE = ("format='auto' needs core/perfmodel.py, which is not "
                     "ported yet: ROADMAP.md, queue 1, item 6 (rest of the "
                     "perfmodel).  Name a format: csr, sell, dia, hybrid or "
                     "matrix_free")


@dataclass(frozen=True)
class PlanConfig:
    format: str | None = None
    value_dtype: str | None = None
    backend: str = "auto"
    sigma: int | None = None
    permute: bool = True
    device: object = None            # None = the card; "cpu" = the host

    def __post_init__(self):
        if self.format == "auto":
            raise ValueError(AUTO_FORMAT_SLICE)

    def replace(self, **kw) -> "PlanConfig":
        return dataclasses.replace(self, **kw)

    def sell_kwargs(self) -> dict:
        """Conversion kwargs expressing the sigma request (empty for the
        default, so cached conversions stay those of the plain packer)."""
        if self.permute and self.sigma is None:
            return {}
        return {"sigma": 1 if not self.permute else max(1, int(self.sigma))}
