from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, token_batch_spec
from repro_torch.configs.registry import ARCHS, all_cells, get_arch, get_shape

__all__ = [
    "SHAPES",
    "ArchConfig",
    "ShapeConfig",
    "ARCHS",
    "all_cells",
    "get_arch",
    "get_shape",
    "token_batch_spec",
]
