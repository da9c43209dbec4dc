"""Assigned architecture configs (one module per arch) + registry; copies of
``repro.configs`` (plain data).

Every config is selectable via ``--arch <id>`` in the launchers; the exact
hyper-parameters follow the assignment table (sources inline per module).
"""

from __future__ import annotations

from ..models.config import SHAPES, ModelConfig, ShapeConfig
from .deepseek_moe_16b import CONFIG as deepseek_moe_16b
from .jamba_v0_1_52b import CONFIG as jamba_v0_1_52b
from .mamba2_370m import CONFIG as mamba2_370m
from .minicpm3_4b import CONFIG as minicpm3_4b
from .musicgen_medium import CONFIG as musicgen_medium
from .paligemma_3b import CONFIG as paligemma_3b
from .qwen1_5_4b import CONFIG as qwen1_5_4b
from .qwen3_32b import CONFIG as qwen3_32b
from .qwen3_moe_30b_a3b import CONFIG as qwen3_moe_30b_a3b
from .yi_9b import CONFIG as yi_9b

ARCHS: dict[str, ModelConfig] = {
    c.name: c
    for c in [
        yi_9b,
        qwen3_32b,
        minicpm3_4b,
        qwen1_5_4b,
        paligemma_3b,
        qwen3_moe_30b_a3b,
        deepseek_moe_16b,
        mamba2_370m,
        musicgen_medium,
        jamba_v0_1_52b,
    ]
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch '{name}'; have {sorted(ARCHS)}")
    return ARCHS[name]


def cells() -> list[tuple[str, str]]:
    """All assigned (arch, shape) dry-run cells, with long_500k restricted to
    sub-quadratic archs per the assignment (skips recorded in DESIGN.md)."""
    out = []
    for arch, cfg in ARCHS.items():
        for shape in SHAPES.values():
            if shape.name == "long_500k" and not cfg.sub_quadratic():
                continue
            out.append((arch, shape.name))
    return out


def skipped_cells() -> list[tuple[str, str, str]]:
    out = []
    for arch, cfg in ARCHS.items():
        if not cfg.sub_quadratic():
            out.append(
                (arch, "long_500k",
                 "pure full-attention arch: O(S) KV per token at 524288 is "
                 "out of scope per assignment; see DESIGN.md §Arch-applicability")
            )
    return out


__all__ = ["ARCHS", "SHAPES", "ModelConfig", "ShapeConfig", "get_arch", "cells", "skipped_cells"]
