"""PlanConfig: the compile-time configuration record of an SpMV plan.

The reference's record, cut to the options the port carries, plus the
``device`` the plan runs on:

* ``format`` -- None plans the container as it is; a name ("csr", "ell",
  "jds", "sell", "bsr", "dia", "hybrid", "matrix_free") converts a CSR/COO
  source first (bsr in (8, 128) blocks); ``"auto"`` lets
  ``perfmodel.select_format`` pick (with an autotuned SELL sigma).
  "mf_product" names the electron x phonon operator
  (``core.matrices.holstein_hubbard_operator``), which no source converts to.
* ``value_dtype`` -- value-storage precision (f64, f32, bf16, f16,
  fp8_e4m3, int8); kernels accumulate in >= f32.
* ``chip`` / ``am`` -- the roofline parameters (default: the H100 data
  sheet; ``core.microbench.card_chip()`` is the card with its measured
  bandwidth) and the access model (None: byte widths from the stored
  dtype).
* ``backend`` -- "auto" | "cuda" | "torch" | "loop_reference".
* ``validate`` -- "strict" | "repair" | "off" (``core.validate``) on the
  CSR/COO source at compile time; None inherits ("off" at the plan layer).
* ``tuning`` -- a ``core.tunedb.TuneDB`` or the path of one: its measured
  winners decide ``format="auto"`` and the backend among the entries left
  when no ``cuda`` kernel can run (the warm path).
* ``sigma`` / ``permute`` -- the SELL-C-sigma sorting window; None keeps the
  default window (and autotunes under ``format="auto"``), ``permute=False``
  forces the identity row order.
* ``device`` -- None means the card (and raises without one); "cpu" runs
  the plain PyTorch kernels on the host.

The reference's Pallas tiling fields (``chunk_block``, ``width_block``)
have no counterpart: the CUDA kernels size their own launches.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass

from ..utils.hw import H100, ChipSpec
from .formats import DEFAULT_SELL_SIGMA


def default_sell_sigma() -> int:
    """The default SELL-C-sigma sorting window (``formats.DEFAULT_SELL_SIGMA``)."""
    return DEFAULT_SELL_SIGMA


#: the compile options ``coerce_config`` folds from bare kwargs
_FIELDS = ("format", "value_dtype", "chip", "am", "backend", "validate",
           "tuning", "sigma", "permute", "device")


@dataclass(frozen=True)
class PlanConfig:
    format: str | None = None
    value_dtype: str | None = None
    chip: ChipSpec = H100
    am: object | None = None         # perfmodel.AccessModel
    backend: str = "auto"
    validate: str | None = None      # None = inherit ("off" at plan layer)
    tuning: object | None = None     # TuneDB instance or path
    sigma: int | None = None
    permute: bool = True
    device: object = None            # None = the card; "cpu" = the host

    def replace(self, **kw) -> "PlanConfig":
        return dataclasses.replace(self, **kw)

    def effective_sigma(self, n_rows: int | None = None) -> int:
        """The sigma the packers use: 1 when ``permute=False``, the default
        window when ``sigma=None``, capped at ``n_rows``."""
        if not self.permute:
            return 1
        sigma = default_sell_sigma() if self.sigma is None else max(1, int(self.sigma))
        if n_rows is not None:
            sigma = max(1, min(int(n_rows), sigma))
        return sigma

    def sigma_is_default(self) -> bool:
        """True when sigma/permute carry no explicit request."""
        return self.permute and self.sigma is None

    def sell_kwargs(self) -> dict:
        """Conversion kwargs expressing the sigma request (empty for the
        default, so cached conversions stay those of the plain packer)."""
        if self.sigma_is_default():
            return {}
        return {"sigma": 1 if not self.permute else max(1, int(self.sigma))}


def coerce_config(config: PlanConfig | None, kwargs: dict, *,
                  api: str, stacklevel: int = 3) -> PlanConfig:
    """Fold bare compile kwargs into a ``PlanConfig`` (the reference's
    contract): ``config`` alone is returned; kwargs alone give one
    ``DeprecationWarning`` and a fresh config; both are a ``ValueError``; an
    unknown kwarg, or a ``config`` that is not a ``PlanConfig``, is a
    ``TypeError``."""
    unknown = set(kwargs) - set(_FIELDS)
    if unknown:
        raise TypeError(f"{api}: unknown option(s) {sorted(unknown)!r}; "
                        f"PlanConfig fields are {_FIELDS}")
    if config is not None:
        if kwargs:
            raise ValueError(
                f"{api}: pass either config=PlanConfig(...) or bare kwargs, "
                f"not both (got config and {sorted(kwargs)!r})")
        if not isinstance(config, PlanConfig):
            raise TypeError(f"{api}: config must be a PlanConfig, "
                            f"got {type(config).__name__}")
        return config
    if kwargs:
        warnings.warn(
            f"{api}: bare compile kwargs ({', '.join(sorted(kwargs))}) are "
            "deprecated; pass config=PlanConfig(...) instead",
            DeprecationWarning, stacklevel=stacklevel)
        return PlanConfig(**kwargs)
    return PlanConfig()
