"""Hand-written Hopper kernels for the TT chain, bound with ctypes.

``tt_fused2`` and ``tt_fused2_int8`` run the whole d=2 TT layer in one
launch of ``csrc/tt_fused2.cu`` (they replace ``tt_fused2_pallas`` and
``tt_fused2_int8_pallas`` of ``repro.kernels.tt_contract``).  The source is
compiled with ``nvcc`` for ``sm_90a`` into ``build/`` at the repository
root at first use, keyed by a hash of the sources, and loaded with ctypes.

A wrapper given CPU tensors runs the kernel's plain version
(``kernels.ref``); given CUDA tensors it launches the kernel or raises.
``LAUNCH_COUNTS`` counts kernel launches only.
"""
from __future__ import annotations

import collections
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from repro_torch.core import hw
from .ref import tt_fused2_ref

# kernel launches per kernel name; the CPU plain path does not count
LAUNCH_COUNTS: collections.Counter = collections.Counter()

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
SOURCES = ("tt_fused2.cu",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# fused2 row-tile cap: the largest tile any batch is cut into
MAX_FUSED2_TILE = 32

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def launch_counts() -> dict[str, int]:
    return dict(LAUNCH_COUNTS)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    raise RuntimeError("nvcc not found: put the CUDA toolkit's bin on PATH "
                       "or set CUDA_HOME")


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in SOURCES:
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> tuple[pathlib.Path, str]:
    """Compile the kernels into ``build/<hash>/`` unless already built.
    Returns (library path, compiler log).  The library is written under a
    temporary name and renamed, so a concurrent build never loads a
    partial file."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / "libtt_kernels.so"
    log = out_dir / "build.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out_dir)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp,
           *[str(CSRC / name) for name in SOURCES]]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    text = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{text}")
    log.write_text(text)
    os.replace(tmp, lib)
    return lib, text


def _lib() -> ctypes.CDLL:
    global _LIB
    with _LIB_LOCK:
        if _LIB is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            p, i = ctypes.c_void_p, ctypes.c_int
            for name in ("tt_fused2_f32", "tt_fused2_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p] + [i] * 8 + [p]
                fn.restype = i
            for name in ("tt_fused2_int8_f32", "tt_fused2_int8_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, p] + [i] * 8 + [p]
                fn.restype = i
            _LIB = lib
        return _LIB


# ---------------------------------------------------------------------------
# fused d=2 TT layer
# ---------------------------------------------------------------------------

_ACT_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def check_fused2_fits(n1: int, m2: int, r1: int, smem_bytes: int) -> None:
    """Raise when the fp32 intermediate of one row, ``n1·m2·r1·4`` bytes,
    does not fit one block's shared memory."""
    row = n1 * m2 * r1 * 4
    if row > smem_bytes:
        raise ValueError(
            f"fused2 intermediate of {row} bytes per row (n1={n1}, m2={m2}, "
            f"r1={r1}) exceeds {smem_bytes} bytes of shared memory per block")


def fused2_batch_tile(n1: int, m2: int, r1: int, smem_bytes: int) -> int:
    """Largest power-of-two row tile (≤ ``MAX_FUSED2_TILE``) whose fp32
    intermediate ``bb·n1·m2·r1·4`` bytes fits one block's shared memory.
    Raises when even one row does not fit."""
    check_fused2_fits(n1, m2, r1, smem_bytes)
    bb = MAX_FUSED2_TILE
    while bb * n1 * m2 * r1 * 4 > smem_bytes:
        bb //= 2
    return bb


def launch_geometry(B: int, m1: int, max_tile: int, sm_count: int
                    ) -> tuple[int, int]:
    """(row tile, m1 splits) of one launch.  Rows are cut finer than
    ``max_tile`` (what shared memory holds) until the row tiles cover the
    SMs; when there are fewer row tiles than SMs, stage 2's columns are
    split across blocks (at least 32 columns per block)."""
    bb = max(1, min(max_tile, -(-B // sm_count)))
    tiles = -(-B // bb)
    splits = max(1, min(sm_count // tiles, -(-m1 // 32)))
    return bb, splits


def _check(x, p2, p1, dims, weight_dtype, scales=None) -> None:
    n1, n2, m1, m2, r1 = (int(v) for v in dims)
    if x.dtype not in _ACT_SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    want = x.dtype if weight_dtype is None else weight_dtype
    for name, t, shape in (("x", x, None), ("p2", p2, (n2, m2 * r1)),
                           ("p1", p1, (n1 * r1, m1))):
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if shape is not None:
            if tuple(t.shape) != shape:
                raise ValueError(
                    f"{name} has shape {tuple(t.shape)}, expected {shape} "
                    f"for dims {tuple(dims)}")
            if t.dtype != want:
                raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if x.dim() != 2 or x.shape[1] != n1 * n2:
        raise ValueError(
            f"x must be [B, {n1 * n2}] for dims {tuple(dims)}, got "
            f"{tuple(x.shape)}")
    if scales is not None:
        if scales.device != x.device:
            raise ValueError(f"scales are on {scales.device}, x on "
                             f"{x.device}")
        if scales.dtype != torch.float32 or tuple(scales.shape) != (2,):
            raise ValueError(
                f"scales must be float32 [2] ([s2, s1]), got "
                f"{scales.dtype} {tuple(scales.shape)}")
        if not scales.is_contiguous():
            raise ValueError("scales must be contiguous")


def _launch_fused2(name: str, x, p2, p1, scales, dims):
    n1, n2, m1, m2, r1 = (int(v) for v in dims)
    B = x.shape[0]
    y = torch.empty((B, m1 * m2), dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    spec = hw.device_spec(x.device)
    bb, splits = launch_geometry(
        B, m1, fused2_batch_tile(n1, m2, r1, spec.smem_per_block),
        spec.sm_count)
    fn = getattr(_lib(), f"{name}_{_ACT_SUFFIX[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), p2.data_ptr(), p1.data_ptr()]
    if scales is not None:
        ptrs.append(scales.data_ptr())
    with torch.cuda.device(x.device):
        err = fn(*ptrs, y.data_ptr(), B, n1, n2, m1, m2, r1, bb, splits,
                 stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    LAUNCH_COUNTS[name] += 1
    return y


def tt_fused2(x: torch.Tensor, p2: torch.Tensor, p1: torch.Tensor,
              dims: tuple[int, int, int, int, int]) -> torch.Tensor:
    """Fused d=2 TT layer.  ``x [B, n1·n2]`` → ``y [B, m1·m2]`` in
    ``x.dtype`` (float32 or bfloat16).

    ``p2 [n2, m2·r1]`` and ``p1 [n1·r1, m1]`` are the packed cores
    (``core.packing.pack_core``) in ``x.dtype``; ``dims = (n1, n2, m1, m2,
    r1)``.  The row tile is the largest that the card's shared memory
    holds (``fused2_batch_tile``)."""
    _check(x, p2, p1, dims, None)
    if x.device.type == "cpu":
        return tt_fused2_ref(x, p2, p1, dims)
    if x.device.type != "cuda":
        raise ValueError(f"tt_fused2 runs on cuda or cpu, not {x.device}")
    return _launch_fused2("tt_fused2", x, p2, p1, None, dims)


def tt_fused2_int8(x: torch.Tensor, p2: torch.Tensor, p1: torch.Tensor,
                   scales: torch.Tensor,
                   dims: tuple[int, int, int, int, int]) -> torch.Tensor:
    """int8 fused d=2 TT layer: ``p2``/``p1`` are int8 packed cores and
    ``scales`` their fp32 scales ``[s2, s1]`` (execution order), a device
    tensor on ``x``'s device.  Each stage's fp32 output is multiplied by its
    core's scale."""
    _check(x, p2, p1, dims, torch.int8, scales)
    if x.device.type == "cpu":
        return tt_fused2_ref(x, p2, p1, dims, scales)
    if x.device.type != "cuda":
        raise ValueError(f"tt_fused2_int8 runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_fused2("tt_fused2_int8", x, p2, p1, scales, dims)
