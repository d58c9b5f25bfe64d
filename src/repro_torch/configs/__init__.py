from . import archs, base, holstein  # noqa: F401
from .archs import ARCHS  # noqa: F401
from .base import SHAPES, input_specs, reduced, shape_applicable, smoke_batch  # noqa: F401
