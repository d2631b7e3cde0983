from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.registry import ARCHS, all_cells, get_arch, get_shape

__all__ = [
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "ARCHS",
    "all_cells",
    "get_arch",
    "get_shape",
]
