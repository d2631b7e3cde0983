"""Architecture registry: ``--arch <id>`` resolution."""
from __future__ import annotations

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig
from repro_torch.configs.llama3_8b import CONFIG as _llama3_8b
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2_20b
from repro_torch.configs.granite_3_8b import CONFIG as _granite_3_8b
from repro_torch.configs.llama3_405b import CONFIG as _llama3_405b
from repro_torch.configs.falcon_mamba_7b import CONFIG as _falcon_mamba_7b
from repro_torch.configs.arctic_480b import CONFIG as _arctic_480b
from repro_torch.configs.grok_1_314b import CONFIG as _grok_1_314b
from repro_torch.configs.seamless_m4t_medium import CONFIG as _seamless_m4t_medium
from repro_torch.configs.recurrentgemma_2b import CONFIG as _recurrentgemma_2b
from repro_torch.configs.llama_3_2_vision_11b import CONFIG as _llama_3_2_vision_11b

ARCHS: dict[str, ArchConfig] = {
    c.name: c
    for c in (
        _llama3_8b,
        _internlm2_20b,
        _granite_3_8b,
        _llama3_405b,
        _falcon_mamba_7b,
        _arctic_480b,
        _grok_1_314b,
        _seamless_m4t_medium,
        _recurrentgemma_2b,
        _llama_3_2_vision_11b,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; known: {sorted(SHAPES)}")
    return SHAPES[name]


def all_cells(include_skips: bool = False):
    """Every assigned (arch, shape) cell; skipped cells included on request."""
    for arch in ARCHS.values():
        for shape in SHAPES.values():
            if arch.supports(shape):
                yield arch, shape, True
            elif include_skips:
                yield arch, shape, False
