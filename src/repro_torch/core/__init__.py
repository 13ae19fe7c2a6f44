"""The mapping pipeline on torch tensors; the public entry point is the
``Mapper`` session of ``repro_torch.core.mapper``; ``costmodel`` is the
paper's analytic model."""
from . import costmodel  # noqa: F401
from .index import GenomeIndex, build_index  # noqa: F401
from .mapper import Mapper, MapperStats, MappingPlan  # noqa: F401
from .pipeline import MapperConfig, MappingResult  # noqa: F401
