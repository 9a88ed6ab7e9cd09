"""Declarative parameter specs.

Models are described as nested dicts (and per-layer lists) of
``ParamSpec`` (shape + init law + dtype).  ``init_tree`` turns a spec tree
into a tree of tensors of the same structure, drawing every leaf from one
``torch.Generator`` in a fixed traversal order.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: tuple[int, ...]
    init: str = "normal"             # normal | zeros | ones
    scale: float = 1.0               # stddev for 'normal'
    dtype: torch.dtype = torch.float32


def map_tree(fn, tree):
    """Apply ``fn`` to every leaf of a dict/list tree."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [map_tree(fn, v) for v in tree]
    return fn(tree)


def init_leaf(s: ParamSpec, generator: torch.Generator,
              device: torch.device) -> torch.Tensor:
    if s.init == "zeros":
        return torch.zeros(s.shape, dtype=s.dtype, device=device)
    if s.init == "ones":
        return torch.ones(s.shape, dtype=s.dtype, device=device)
    if s.init == "normal":
        w = torch.randn(s.shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (w * s.scale).to(s.dtype)
    raise ValueError(s.init)


def init_tree(tree, generator: torch.Generator, device: torch.device):
    """Initialize every leaf; ``generator`` must live on ``device``."""
    return map_tree(lambda s: init_leaf(s, generator, device), tree)
