"""Target hardware model: one NVIDIA H100 SXM (Hopper, sm_90a).

``device_spec`` reads the card's own properties when a card is present
and falls back to the data-sheet figures otherwise.  The data sheet only
serves planning on the CPU (tests, plan rehearsal); it never stands in
for a device in a measurement.  Bandwidth and peak rates are not device
properties, so they always come from the data sheet.
"""
from __future__ import annotations

import dataclasses
import functools

import torch


@dataclasses.dataclass(frozen=True)
class GPUSpec:
    name: str
    sm_count: int
    smem_per_block: int          # opt-in dynamic shared memory per block
    l2_bytes: int
    hbm_bytes: int
    hbm_bw: float                # bytes/s
    peak_flops: dict             # dtype name → dense FLOP/s
    source: str                  # 'device' | 'datasheet'


# NVIDIA H100 SXM data sheet (dense rates, 700 W power limit).
H100_SXM = GPUSpec(
    name="NVIDIA H100 80GB HBM3 (data sheet)",
    sm_count=132,
    smem_per_block=232_448,
    l2_bytes=50 * 2 ** 20,
    hbm_bytes=80 * 10 ** 9,
    hbm_bw=3.35e12,
    peak_flops={"float32": 67e12, "tfloat32": 495e12,
                "bfloat16": 989e12, "float16": 989e12, "int8": 1979e12},
    source="datasheet",
)


@functools.lru_cache(maxsize=None)
def _cuda_spec(index: int) -> GPUSpec:
    p = torch.cuda.get_device_properties(index)
    return dataclasses.replace(
        H100_SXM, name=p.name, sm_count=p.multi_processor_count,
        smem_per_block=getattr(p, "shared_memory_per_block_optin",
                               H100_SXM.smem_per_block),
        l2_bytes=getattr(p, "L2_cache_size", H100_SXM.l2_bytes),
        hbm_bytes=p.total_memory, source="device")


def device_spec(device: torch.device | str | None = None) -> GPUSpec:
    """The card's model: its own properties for a CUDA device, the data
    sheet when ``device`` is the CPU or no card is present (planning)."""
    dev = torch.device(device) if device is not None else None
    if dev is not None and dev.type == "cuda":
        return _cuda_spec(dev.index if dev.index is not None
                          else torch.cuda.current_device())
    if dev is None and torch.cuda.is_available():
        return _cuda_spec(torch.cuda.current_device())
    return H100_SXM


def bound_seconds(bytes_moved: float, flops: float, dtype_name: str,
                  spec: GPUSpec = H100_SXM) -> tuple[float, str]:
    """Least time the card could take: the larger of bytes over the HBM
    rate and operations over the peak rate of ``dtype_name``; returns
    (seconds, 'bytes' | 'operations')."""
    t_bytes = bytes_moved / spec.hbm_bw
    t_ops = flops / spec.peak_flops[dtype_name]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")
