"""Carry parameters of the JAX reference package into the port.

The reference stacks each layer group's parameters on a leading layer axis
(``g0/b0/...`` leaves of shape ``[L, ...]``); the port keeps one dict per
layer.  ``from_jax_params`` unstacks, checks every leaf's shape against the
port's own specs and raises on any mismatch.  int8 bundles carry their
``scales [L, d]``, or ``[L, E, d]`` for a stack of experts (whose cores are
``[L, E, r0, n, m, r1]`` and router ``[L, d, E]``).  An encoder-decoder's
tree also holds the dense ``frontend_proj``, ``enc_norm`` and the stacked
encoder groups ``enc_g{gi}``, and its decoder blocks ``ln_x`` and
``xattn``; a vision-language model's the dense ``projector`` ``{"w"}``:
the port's specs name them, so they cross as every other leaf, fp or
int8.  Leaves arrive as numpy arrays (``jax.tree.map(np.asarray,
params)`` on the reference side), so this module needs no JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.models.model import Model
from repro_torch.models.spec import ParamSpec


def _tensor(arr: np.ndarray, dtype: torch.dtype, device) -> torch.Tensor:
    if arr.dtype.kind not in "biuf":          # bfloat16 and friends
        arr = arr.astype(np.float32)
    return torch.from_numpy(np.array(arr)).to(device=device, dtype=dtype)


def _leaf(node, spec: ParamSpec, path: str, layer, device) -> torch.Tensor:
    """``layer`` is None or (index, count) into a leading layer axis."""
    arr = np.asarray(node)
    if layer is not None:
        i, n = layer
        if arr.ndim == 0 or arr.shape[0] != n:
            raise ValueError(f"{path}: leading layer axis of shape "
                             f"{arr.shape} does not hold {n} layers")
        arr = arr[i]
    if tuple(arr.shape) != tuple(spec.shape):
        raise ValueError(f"{path}: shape {tuple(arr.shape)} does not match "
                         f"the port's spec {tuple(spec.shape)}")
    return _tensor(arr, spec.dtype, device)


def _quantized_bundle(node: dict, spec: dict, path: str, layer, device
                      ) -> dict:
    d = len(spec)
    if set(node) != set(spec) | {"scales"}:
        raise ValueError(f"{path}: int8 bundle keys {sorted(node)} do not "
                         f"match cores {sorted(spec)} + scales")
    out = {}
    for name, s in spec.items():
        arr = np.asarray(node[name])
        if arr.dtype != np.int8:
            raise ValueError(f"{path}/{name}: int8 bundle core has dtype "
                             f"{arr.dtype}")
        out[name] = _leaf(arr, ParamSpec(s.shape, dtype=torch.int8),
                          f"{path}/{name}", layer, device)
    lead = tuple(next(iter(spec.values())).shape[:-4])   # experts axis
    out["scales"] = _leaf(node["scales"], ParamSpec(lead + (d,)),
                          f"{path}/scales", layer, device)
    return out


def _convert(node, spec, path: str, layer, device):
    if isinstance(spec, ParamSpec):
        return _leaf(node, spec, path, layer, device)
    if isinstance(spec, list):
        if layer is not None:
            raise ValueError(f"{path}: nested layer groups are not supported")
        return [_convert(node, s, path, (i, len(spec)), device)
                for i, s in enumerate(spec)]
    if not isinstance(node, dict):
        raise ValueError(f"{path}: expected a dict, got {type(node).__name__}")
    if "scales" in node and all(isinstance(s, ParamSpec)
                                for s in spec.values()):
        return _quantized_bundle(node, spec, path, layer, device)
    if set(node) != set(spec):
        raise ValueError(f"{path or '/'}: keys {sorted(node)} do not match "
                         f"the port's {sorted(spec)}")
    return {k: _convert(node[k], spec[k], f"{path}/{k}", layer, device)
            for k in spec}


def from_jax_params(tree: dict, model: Model) -> dict:
    """Port parameters for ``model`` (on ``model.device``) from the
    reference's parameter tree with numpy leaves."""
    return _convert(tree, model.param_specs(), "", None, model.device)
