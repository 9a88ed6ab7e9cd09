"""Hand-written Hopper kernels for the TT chain, bound with ctypes.

Each wrapper replaces one Pallas kernel of ``repro.kernels.tt_contract``:

``tt_fused2[_int8]``       the whole d=2 layer in one launch
                           (``csrc/tt_fused2.cu``; ``tt_fused2[_int8]_pallas``)
``tt_fused2_experts[_int8]`` the d=2 layer of every expert of a stack in
                           one launch (same source; the Pallas kernels
                           under ``vmap`` over the experts)
``tt_fused_chain[_int8]``  the whole chain of any depth d ≥ 2 in one launch
                           (``csrc/tt_chain.cu``;
                           ``tt_fused_chain[_int8]_pallas``)
``tt_step[_int8]``         one step on the raw core, one launch per core
                           (``csrc/tt_step.cu``; ``tt_step[_int8]_pallas``)

The sources are compiled with ``nvcc`` for ``sm_90a`` into one library
under ``build/`` at the repository root at first use, keyed by a hash of
the sources, and loaded with ctypes.

A wrapper given CPU tensors runs the kernel's plain version
(``kernels.ref``); given CUDA tensors it launches the kernel or raises.
``LAUNCH_COUNTS`` counts kernel launches only; a launch made while the
stream captures a CUDA graph is counted in ``CAPTURE_COUNTS`` instead.
"""
from __future__ import annotations

import collections
import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading

import torch

from repro_torch.core import hw
from repro_torch.core.packing import chain_state_sizes
from .ref import (tt_fused2_experts_ref, tt_fused2_ref, tt_fused_chain_ref,
                  tt_step_ref)

# kernel launches per kernel name; the CPU plain path does not count
LAUNCH_COUNTS: collections.Counter = collections.Counter()
# launches recorded into a CUDA graph under capture, per kernel name: they
# run at every replay of the graph, where no wrapper runs
# (``models.graph.DecodeGraph`` multiplies its share by its replays)
CAPTURE_COUNTS: collections.Counter = collections.Counter()

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build"
SOURCES = ("tt_fused2.cu", "tt_chain.cu", "tt_step.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# fused2 (csrc/tt_fused2.cu): the ring depths of its two stages (the
# source's kStages1, kStages2), the stage-1 rows a block aims for (8
# tensor-core row tiles), the stage-1 ring's shared-memory budget, the
# widest stage-2 column chunk, the block's warps (kThreads / 32), and the
# most outputs one stage's block tile may hold by activation bytes: bf16,
# 16 warps × 2 accumulator tiles of 16×16; fp32, 512 threads × 8 (kMaxAcc,
# kMaxOut)
FUSED2_STAGES = (4, 2)
FUSED2_ROWS1 = 128
FUSED2_RING1 = 80 * 1024
FUSED2_NCT = 256
FUSED2_WARPS = 16
FUSED2_MAX_TILE = {2: 8192, 4: 4096}
# fused chain (csrc/tt_chain.cu): the most rows one block takes
MAX_CHAIN_TILE = 32
# step kernel (csrc/tt_step.cu): threads per block (kThreads), b rows and
# output columns of one thread's register tile (kRB, kRJ), the ring depth
# (kStages), the sizes a block tile's rows and columns are chosen from, and
# the bytes one ring slot (a chunk of G and of X) aims for
STEP_THREADS = 256
STEP_RB = 4
STEP_RJ = 4
STEP_STAGES = 2
STEP_TILES = (64, 32, 16, 8, 4)
STEP_SLOT_BYTES = 48 * 1024

_LIB: ctypes.CDLL | None = None
_LIB_LOCK = threading.Lock()


def reset_launch_counts() -> None:
    LAUNCH_COUNTS.clear()


def launch_counts() -> dict[str, int]:
    return dict(LAUNCH_COUNTS)


def capture_counts() -> dict[str, int]:
    return dict(CAPTURE_COUNTS)


def _count(name: str) -> None:
    """One launch of ``name`` on the current stream: a launch, or a node of
    the graph that the stream is capturing."""
    if torch.cuda.is_available() and torch.cuda.is_current_stream_capturing():
        CAPTURE_COUNTS[name] += 1
    else:
        LAUNCH_COUNTS[name] += 1


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
    """Compile the kernels into ``build/<hash>/`` unless already built:
    one ``nvcc`` per source, all started together, then one link.
    Returns (library path, compiler log).  The library is written under a
    temporary name and renamed, so a concurrent build never loads a
    partial file."""
    out_dir = BUILD_DIR / source_hash()
    lib = out_dir / "libtt_kernels.so"
    log = out_dir / "build.log"
    if lib.exists():
        return lib, log.read_text() if log.exists() else ""
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as work:
        objs = [os.path.join(work, name + ".o") for name in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(CSRC / name)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for name, obj in zip(SOURCES, objs)]
        outs = [proc.communicate()[0] for proc in procs]
        text = "".join(outs)
        failed = [name for name, proc in zip(SOURCES, procs)
                  if proc.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{text}")
        tmp = os.path.join(work, "lib.so")
        proc = subprocess.run([nvcc, "-shared", "-o", tmp, *objs],
                              capture_output=True, text=True)
        text += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{text}")
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
            # x, p2, p1, [scales,] y, B, n1, n2, m1, m2, r1, bb, g, nc,
            # kc, nct, smem, stream
            for name in ("tt_fused2_f32", "tt_fused2_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p] + [i] * 12 + [p]
                fn.restype = i
            for name in ("tt_fused2_int8_f32", "tt_fused2_int8_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, p] + [i] * 12 + [p]
                fn.restype = i
            # the expert-batched entries: E before B
            for name in ("tt_fused2_experts_f32", "tt_fused2_experts_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p] + [i] * 13 + [p]
                fn.restype = i
            for name in ("tt_fused2_experts_int8_f32",
                         "tt_fused2_experts_int8_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, p] + [i] * 13 + [p]
                fn.restype = i
            # x, packed (host void*[d]), ns, ms, ranks (host int[]), d,
            # [scales,] tables, y, B, bb, g, g2, ncc, stages, smem, stream
            for name in ("tt_fused_chain_f32", "tt_fused_chain_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, p, i, p, p] + [i] * 7 + [p]
                fn.restype = i
            for name in ("tt_fused_chain_int8_f32",
                         "tt_fused_chain_int8_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p, p, i, p, p, p] + [i] * 7 + [p]
                fn.restype = i
            # G, X, [scale,] out, r0, n, m, r1, b, tb, tm, tr, nc, kv,
            # smem, stream
            for name in ("tt_step_f32", "tt_step_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p] + [i] * 11 + [p]
                fn.restype = i
            for name in ("tt_step_int8_f32", "tt_step_int8_bf16"):
                fn = getattr(lib, name)
                fn.argtypes = [p, p, p, p] + [i] * 11 + [p]
                fn.restype = i
            _LIB = lib
        return _LIB


# ---------------------------------------------------------------------------
# fused d=2 TT layer
# ---------------------------------------------------------------------------

_ACT_SUFFIX = {torch.float32: "f32", torch.bfloat16: "bf16"}


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


def _ksplit(tiles: int) -> int:
    """Warps sharing one 16×16 tile's k-steps (the source's ``ksplit``):
    the largest power of two that ``tiles`` leave room for."""
    split = 1
    while 2 * split * tiles <= FUSED2_WARPS:
        split *= 2
    return split


def _pow2_at_least(a: int, lo: int) -> int:
    p = lo
    while p < a:
        p *= 2
    return p


def _stage1_width(g: int, r1: int, act_bytes: int) -> int:
    """Stage 1's padded tile width: a multiple of 16 (one tensor-core
    tile) for bf16; for fp32 a power of two, so that each thread owns one
    column (the source's ``N1p``)."""
    return _up(g * r1, 16) if act_bytes == 2 else _pow2_at_least(g * r1, 16)


def fused2_group(m2: int, r1: int) -> int:
    """i2 values per block: enough that stage 1's ``g·r1`` columns fill
    one 16-wide tensor-core tile, where m2 has that many."""
    return min(m2, -(-16 // r1))


def fused2_smem_bytes(n1: int, r1: int, bb: int, g: int, kc: int, nct: int,
                      act_bytes: int, w_bytes: int) -> int:
    """Shared memory of one fused2 block: the stage-2 left operand A (a
    bf16 high and low part, or fp32), the ring of ``FUSED2_STAGES[1]`` P1
    column chunks, and one region that holds first the ring of
    ``FUSED2_STAGES[0]`` (x, P2) chunks, then stage 1's and stage 2's
    fp32 partial sums.  The layout of ``csrc/tt_fused2.cu``'s
    ``make_geo``, which refuses a launch whose byte count differs."""
    tc = act_bytes == 2                       # bf16: tensor cores
    conv = tc and w_bytes == 1                # int8 cores widened to bf16
    s1, s2 = FUSED2_STAGES
    M1p, N1p = _up(bb * n1, 16), _stage1_width(g, r1, act_bytes)
    K2p, M2p = _up(n1 * r1, 16), _up(g * bb, 16)
    ldA = K2p + (8 if tc else 4)
    ldp1 = nct + 16 // w_bytes
    a_part = _up(M2p * ldA * (2 if tc else 4), 128)
    ring2 = s2 * _up(K2p * ldp1 * w_bytes, 128) + (
        _up(K2p * (nct + 8) * 2, 128) if conv else 0)
    slot1 = (_up(M1p * (kc + 16 // act_bytes) * act_bytes, 128)
             + _up(kc * (N1p + 16 // w_bytes) * w_bytes, 128))
    ring1 = s1 * slot1 + (_up(kc * (N1p + 8) * 2, 128) if conv else 0)
    split1 = _ksplit(M1p // 16 * (N1p // 16)) if tc else 1
    split2 = _ksplit(M2p // 16 * (nct // 16)) if tc else 1
    region = max(ring1, split1 * M1p * (N1p + 4) * 4,
                 split2 * M2p * (nct + 4) * 4)
    return (2 if tc else 1) * a_part + ring2 + _up(region, 128)


def _fused2_block_fits(n1: int, r1: int, g: int, bb: int, smem_bytes: int,
                       act_bytes: int, w_bytes: int) -> bool:
    """Whether a block of ``bb`` rows and ``g`` i2 values fits at the
    smallest chunks (16 n2 values, 16 columns): its stage tiles within
    ``FUSED2_MAX_TILE`` outputs and its shared memory within
    ``smem_bytes``."""
    most = FUSED2_MAX_TILE[act_bytes]
    return (_up(bb * n1, 16) * _stage1_width(g, r1, act_bytes) <= most
            and _up(g * bb, 16) * 16 <= most
            and fused2_smem_bytes(n1, r1, bb, g, 16, 16, act_bytes,
                                  w_bytes) <= smem_bytes)


def check_fused2_fits(n1: int, m2: int, r1: int, smem_bytes: int,
                      act_bytes: int = 4, w_bytes: int = 4) -> None:
    """Raise when a block of one row does not fit (``_fused2_block_fits``;
    by default priced for fp32 activations and cores, the largest)."""
    g = fused2_group(m2, r1)
    if not _fused2_block_fits(n1, r1, g, 1, smem_bytes, act_bytes, w_bytes):
        need = fused2_smem_bytes(n1, r1, 1, g, 16, 16, act_bytes, w_bytes)
        raise ValueError(
            f"a fused2 block of one row (n1={n1}, m2={m2}, r1={r1}) needs "
            f"{need} bytes of shared memory per block, {smem_bytes} "
            f"available, and at most {FUSED2_MAX_TILE[act_bytes]} outputs "
            f"per stage tile")


def fused2_batch_tile(n1: int, m2: int, r1: int, smem_bytes: int,
                      act_bytes: int = 4, w_bytes: int = 4) -> int:
    """Largest row tile, up to the ``FUSED2_ROWS1 // n1`` rows that give
    stage 1 its 128 rows, of which one block fits
    (``_fused2_block_fits``).  Raises when even one row does not fit."""
    check_fused2_fits(n1, m2, r1, smem_bytes, act_bytes, w_bytes)
    g = fused2_group(m2, r1)
    bb = max(1, FUSED2_ROWS1 // n1)
    while not _fused2_block_fits(n1, r1, g, bb, smem_bytes, act_bytes,
                                 w_bytes):
        bb -= 1
    return bb


@dataclasses.dataclass(frozen=True)
class Fused2Geometry:
    """One fused2 launch: rows per block, i2 per block, i1 per block,
    n2 values per stage-1 chunk, columns per stage-2 chunk, shared memory
    per block and the grid (row tiles, i2 groups, i1 slices)."""
    bb: int
    g: int
    nc: int
    kc: int
    nct: int
    smem: int
    grid: tuple[int, int, int]


@functools.lru_cache(maxsize=None)
def fused2_geometry(B: int, dims: tuple, act_bytes: int, w_bytes: int,
                    sm_count: int, smem_bytes: int,
                    experts: int = 1) -> Fused2Geometry:
    """Tiles of one fused2 launch (memoized: a decode step asks for the
    same few every time); stage 1 is never recomputed across i2
    groups.  ``experts`` > 1 is the expert-batched launch: ``B`` rows for
    each of ``experts`` problems, every block on one expert, the experts
    folded into the grid's first axis (``experts`` × row tiles).  Every
    count of blocks below is over all the experts, so a decode batch of 8
    experts × 8 rows cuts m1 into 2 slices, not the 16 one problem would
    take.

    * Many rows (prefill): the widest i2 group g (a divisor of m2) whose
      blocks of 16 // g rows, one 16-row stage-2 tile each, still give
      90% of the SMs a block without cutting m1.  At 256 rows that is
      g = m2 = 8 and 2 rows: 128 blocks, each reading only its own rows
      of x, and writing y's rows in whole runs of m2 outputs.
    * Otherwise i2 groups of ``fused2_group`` values (stage 1 one
      tensor-core tile wide) and row tiles of up to ``fused2_batch_tile``
      rows (16 at n1 = 8: 128 stage-1 rows), never more than B.  When
      row tiles × i2 groups leave SMs idle (decode: 4 rows give 1 × 8
      blocks), m1 is cut into ``sm_count // blocks`` slices of a multiple
      of 16 columns, each block recomputing its stage 1: that costs
      ``bb·n1·n2·g·r1`` MACs per block on the tensor cores, against the
      120–128 SMs the split puts to work.
    * Stage 2 loops over chunks of up to ``FUSED2_NCT`` columns (for fp32
      a power of two, one column per thread); stage 1 over chunks of
      ``kc`` n2 values, as wide as the stage-1 ring's budget
      (``FUSED2_RING1``) allows, up to the width at which the 3 chunks
      issued before the first wait cover n2: at decode all of x and the P2
      slice are in flight at once.  Chunks shrink until the block fits
      ``smem_bytes``."""
    n1, n2, m1, m2, r1 = (int(v) for v in dims)
    g = fused2_group(m2, r1)
    bb = min(B, fused2_batch_tile(n1, m2, r1, smem_bytes, act_bytes,
                                  w_bytes))
    for wide in range(m2, g, -1):
        rows = min(B, max(1, 16 // wide))
        if m2 % wide == 0 and experts * -(-B // rows) * (m2 // wide) >= \
                sm_count * 9 // 10 and _fused2_block_fits(
                    n1, r1, wide, rows, smem_bytes, act_bytes, w_bytes):
            g, bb = wide, rows
            break
    blocks = experts * -(-B // bb) * -(-m2 // g)
    splits = max(1, min(sm_count // blocks, -(-m1 // 16)))
    nc = _up(-(-m1 // splits), 16)
    M1p, M2p = _up(bb * n1, 16), _up(g * bb, 16)
    N1p = _stage1_width(g, r1, act_bytes)

    def narrower(nct: int) -> int:
        return nct - 16 if act_bytes == 2 else nct // 2

    nct = min(nc, FUSED2_NCT)
    if act_bytes == 4:
        nct = 1 << (nct.bit_length() - 1)
    while M2p * nct > FUSED2_MAX_TILE[act_bytes]:
        nct = narrower(nct)
    s1 = FUSED2_STAGES[0]
    budget = FUSED2_RING1 // s1 // (M1p * act_bytes + N1p * w_bytes)
    kc = max(16, min(_up(-(-n2 // (s1 - 1)), 16), budget // 16 * 16))
    while True:
        smem = fused2_smem_bytes(n1, r1, bb, g, kc, nct, act_bytes, w_bytes)
        if smem <= smem_bytes:
            break
        if kc > 32:
            kc -= 16
        elif nct > 64:
            nct = narrower(nct)
        elif kc > 16:
            kc -= 16
        else:
            nct = narrower(nct)  # ≥ 16: fused2_batch_tile fit at 16
    grid = (experts * -(-B // bb), -(-m2 // g), -(-m1 // nc))
    if max(grid[1:]) > 65535:
        raise ValueError(f"fused2 grid {grid} exceeds 65535 blocks per axis")
    return Fused2Geometry(bb, g, nc, kc, nct, smem, grid)


def _check_device(x, named) -> None:
    for name, t in named:
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_scales(scales, x, n: int, what: str) -> None:
    if scales.device != x.device:
        raise ValueError(f"scales are on {scales.device}, x on {x.device}")
    if scales.dtype != torch.float32 or scales.numel() != n:
        raise ValueError(f"scales must be float32 with {n} value(s) "
                         f"({what}), got {scales.dtype} "
                         f"{tuple(scales.shape)}")
    if not scales.is_contiguous():
        raise ValueError("scales must be contiguous")


def _check(x, p2, p1, dims, weight_dtype, scales=None,
           experts: bool = False) -> None:
    """Arguments of one fused2 launch; ``experts``: a leading experts axis
    E on ``x`` ([E, C, N]), the packed cores and the scales ([E, 2])."""
    n1, n2, m1, m2, r1 = (int(v) for v in dims)
    if x.dtype not in _ACT_SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    want = x.dtype if weight_dtype is None else weight_dtype
    _check_device(x, [("x", x), ("p2", p2), ("p1", p1)])
    lead = tuple(x.shape[:1]) if experts else ()
    for name, t, shape in (("p2", p2, lead + (n2, m2 * r1)),
                           ("p1", p1, lead + (n1 * r1, m1))):
        if tuple(t.shape) != shape:
            raise ValueError(
                f"{name} has shape {tuple(t.shape)}, expected {shape} "
                f"for dims {tuple(dims)}")
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
    if x.dim() != 2 + experts or x.shape[-1] != n1 * n2:
        raise ValueError(
            f"x must be [{'E, C' if experts else 'B'}, {n1 * n2}] for dims "
            f"{tuple(dims)}, got {tuple(x.shape)}")
    if scales is not None:
        _check_scales(scales, x, 2 * (lead[0] if experts else 1),
                      "[E, 2]: [s2, s1] per expert" if experts
                      else "[s2, s1]")
        if experts and tuple(scales.shape) != lead + (2,):
            raise ValueError(f"scales must be [E, 2] = {lead + (2,)}, got "
                             f"{tuple(scales.shape)}")


def _launch_fused2(name: str, x, p2, p1, scales, dims):
    """One launch of ``name``: a 3-D ``x [E, C, N]`` goes to the
    expert-batched entry (E passed before the rows), a 2-D one to the
    plain entry."""
    n1, n2, m1, m2, r1 = (int(v) for v in dims)
    lead = tuple(x.shape[:-1])
    E, B = (1, lead[0]) if len(lead) == 1 else lead
    y = torch.empty(lead + (m1 * m2,), dtype=x.dtype, device=x.device)
    if E * B == 0:
        return y
    spec = hw.device_spec(x.device)
    geo = fused2_geometry(B, (n1, n2, m1, m2, r1), x.element_size(),
                          p2.element_size(), spec.sm_count,
                          spec.smem_per_block, *((E,) if len(lead) == 2
                                                 else ()))
    fn = getattr(_lib(), f"{name}_{_ACT_SUFFIX[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    ptrs = [x.data_ptr(), p2.data_ptr(), p1.data_ptr()]
    if scales is not None:
        ptrs.append(scales.data_ptr())
    ptrs.append(y.data_ptr())
    if len(lead) == 2:
        ptrs.append(E)
    with torch.cuda.device(x.device):
        err = fn(*ptrs, B, n1, n2, m1, m2, r1, geo.bb, geo.g, geo.nc,
                 geo.kc, geo.nct, geo.smem, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)
    return y


def tt_fused2(x: torch.Tensor, p2: torch.Tensor, p1: torch.Tensor,
              dims: tuple[int, int, int, int, int]) -> torch.Tensor:
    """Fused d=2 TT layer.  ``x [B, n1·n2]`` → ``y [B, m1·m2]`` in
    ``x.dtype`` (float32 or bfloat16).

    ``p2 [n2, m2·r1]`` and ``p1 [n1·r1, m1]`` are the packed cores
    (``core.packing.pack_core``) in ``x.dtype``; ``dims = (n1, n2, m1, m2,
    r1)``.  The tiles of the launch come from ``fused2_geometry``."""
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


def tt_fused2_experts(x: torch.Tensor, p2: torch.Tensor, p1: torch.Tensor,
                      dims: tuple[int, int, int, int, int]) -> torch.Tensor:
    """The fused d=2 TT layer of every expert of a stack in one launch:
    ``x [E, C, n1·n2]`` → ``y [E, C, m1·m2]`` in ``x.dtype``, expert ``e``'s
    rows through its own packed cores ``p2 [E, n2, m2·r1]`` and ``p1 [E,
    n1·r1, m1]`` (``core.packing.pack_core`` over the stack), with the body
    of ``tt_fused2``.  The tiles come from ``fused2_geometry(...,
    experts=E)``."""
    _check(x, p2, p1, dims, None, experts=True)
    if x.device.type == "cpu":
        return tt_fused2_experts_ref(x, p2, p1, dims)
    if x.device.type != "cuda":
        raise ValueError(f"tt_fused2_experts runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_fused2("tt_fused2_experts", x, p2, p1, None, dims)


def tt_fused2_experts_int8(x: torch.Tensor, p2: torch.Tensor,
                           p1: torch.Tensor, scales: torch.Tensor,
                           dims: tuple[int, int, int, int, int]
                           ) -> torch.Tensor:
    """int8 ``tt_fused2_experts``: int8 packed cores and each expert's fp32
    scales ``scales [E, 2]`` (``[s2, s1]``, execution order), a device
    tensor on ``x``'s device."""
    _check(x, p2, p1, dims, torch.int8, scales, experts=True)
    if x.device.type == "cpu":
        return tt_fused2_experts_ref(x, p2, p1, dims, scales)
    if x.device.type != "cuda":
        raise ValueError(f"tt_fused2_experts_int8 runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_fused2("tt_fused2_experts_int8", x, p2, p1, scales, dims)


# ---------------------------------------------------------------------------
# fused chain of any depth d >= 2
# ---------------------------------------------------------------------------

# deepest chain one launch of csrc/tt_chain.cu takes (its kMaxD)
MAX_CHAIN_DEPTH = 8


def chain_row_bytes(ns, ms, ranks) -> int:
    """Shared memory one row of the fused chain's states takes: s_1 …
    s_{d-1} in fp32, in two ping-pong buffers (one for d=2), each as large
    as the largest of them.  The plan's eligibility rule."""
    if len(ns) < 2:
        raise ValueError(f"the fused chain needs d >= 2, got d={len(ns)}")
    inner = chain_state_sizes(ns, ms, ranks)[1:-1]
    return min(2, len(inner)) * max(inner) * 4


def check_chain_fits(ns, ms, ranks, smem_bytes: int) -> None:
    """Raise when one row of the chain's states (``chain_row_bytes``) does
    not fit one block's shared memory."""
    row = chain_row_bytes(ns, ms, ranks)
    if row > smem_bytes:
        raise ValueError(
            f"fused chain state of {row} bytes per row (ns={tuple(ns)}, "
            f"ms={tuple(ms)}, ranks={tuple(ranks)}) exceeds {smem_bytes} "
            f"bytes of shared memory per block")


def _chain_steps(ns, ms, ranks, g: int, g2: int):
    """Per step j (execution order, core t = d-1-j): (K, R, m values the
    block takes, n of the next core).  A block takes g values of the first
    step's mode m_{d-1}, g2 of the second step's m_{d-2}, all of the
    others."""
    d = len(ns)
    for j in range(d):
        t = d - 1 - j
        mloc = g if j == 0 else g2 if j == 1 else ms[t]
        yield ns[t] * ranks[t + 1], ranks[t], mloc, ns[t - 1] if t else 1


def chain_tables(dims, bb: int, g: int, g2: int, act_bytes: int
                 ) -> list[int]:
    """The fused chain's address tables (``csrc/tt_chain.cu``) for a block
    of ``bb`` rows, ``g`` m_{d-1} and ``g2`` m_{d-2} values, in four
    variants v = (its g group is the last, ragged one) + 2·(its g2 group
    is): per variant and step j, a row table of ``_up(bb·b_j, 16)``
    entries (b_j the block's b rows per row of x at full groups), then a
    column table of ``_up(g_j·R_j, 16)`` entries (g_j the m values the
    block takes).  Output (r, c) of step j goes to row[r] + col[c]: into
    the next step's left operand (row (b, i // n), column (i % n, rank),
    n the next core's n, row stride K padded to 16 plus 8 bf16 or 4 fp32
    values), or at the last step into y, relative to the block's first
    output.  Entries past a variant's own rows or columns are 0."""
    ns, ms, ranks = dims
    d = len(ns)
    M = 1
    for m in ms:
        M *= m
    full = list(_chain_steps(ns, ms, ranks, g, g2))
    ld = [_up(K, 16) + (8 if act_bytes == 2 else 4) for K, _, _, _ in full]
    out = []
    for v in range(4):
        gn = ms[-1] - (-(-ms[-1] // g) - 1) * g if v & 1 else g
        g2n = ms[-2] - (-(-ms[-2] // g2) - 1) * g2 if v & 2 else g2
        bl = 1
        for n in ns[:-1]:
            bl *= n
        bl_full = bl
        for j, (_, R, mloc, nn) in enumerate(_chain_steps(ns, ms, ranks, gn,
                                                           g2n)):
            rows = torch.zeros(_up(bb * bl_full, 16), dtype=torch.int64)
            cols = torch.zeros(_up(full[j][2] * R, 16), dtype=torch.int64)
            r = torch.arange(bb * bl)
            b, i = r // bl, r % bl
            c = torch.arange(mloc * R)
            if j < d - 1:
                rows[:r.numel()] = ((b * (mloc * bl // nn) + i // nn)
                                    * ld[j + 1] + (i % nn) * R)
                cols[:c.numel()] = (c // R) * (bl // nn) * ld[j + 1] + c % R
            else:
                if d == 2:
                    yo = i
                else:
                    t1 = i // gn
                    yo = ((t1 // g2n) * ms[-2] + t1 % g2n) * ms[-1] + i % gn
                rows[:r.numel()] = b * M + yo
                cols[:c.numel()] = c * (ms[1] if d == 2 else M // ms[0])
            out += rows.tolist() + cols.tolist()
            bl_full = full[j][2] * bl_full // nn
            bl = mloc * bl // nn
    return out


_CHAIN_TABLES: dict = {}


def _chain_tables_on(device, dims, geo: "ChainGeometry", act_bytes: int
                     ) -> torch.Tensor:
    """``chain_tables`` as an int32 tensor on ``device``, made once per
    launch geometry."""
    key = (device, dims, geo.bb, geo.g, geo.g2, act_bytes)
    tab = _CHAIN_TABLES.get(key)
    if tab is None:
        tab = torch.tensor(chain_tables(dims, geo.bb, geo.g, geo.g2,
                                        act_bytes), dtype=torch.int32,
                           device=device)
        _CHAIN_TABLES[key] = tab
    return tab


def chain_smem_bytes(ns, ms, ranks, bb: int, g: int, g2: int, ncc: int,
                     stages: int, act_bytes: int, w_bytes: int) -> int:
    """Shared memory of one fused-chain block of ``bb`` rows, ``g``
    m_{d-1} and ``g2`` m_{d-2} values, core columns staged in chunks of at
    most ``ncc``: two buffers for the steps' left operands (the even steps'
    in one, x's row tile first; the odd steps' in the other), each
    ``[bb·b rows, K padded to 16]`` with a 16-byte pad per row, in x's
    type at step 0 and as fp32 (bf16 high and low parts, or fp32) after;
    ``stages`` ring slots, each one column chunk of a core ``[K padded,
    chunk]`` with a 16-byte pad per row; for int8 cores under bf16
    activations one chunk widened to bf16; every step's int32 address
    tables of its rows and columns.  The layout of ``csrc/tt_chain.cu``'s ``make_geo``, which
    refuses a launch whose byte count differs."""
    tc = act_bytes == 2
    conv = tc and w_bytes == 1
    bl = 1
    for n in ns[:-1]:
        bl *= n
    buf, slot, cbuf, tab = [0, 0], 0, 0, 0
    for j, (K, R, mloc, nn) in enumerate(_chain_steps(ns, ms, ranks, g, g2)):
        Kp = _up(K, 16)
        cc = min(_up(mloc * R, 16), ncc)
        ldA = Kp + (8 if tc else 4)
        buf[j % 2] = max(buf[j % 2], _up(bb * bl, 16) * ldA *
                         (act_bytes if j == 0 else 4))
        slot = max(slot, Kp * (cc + 16 // w_bytes) * w_bytes)
        if conv:
            cbuf = max(cbuf, Kp * (cc + 8) * 2)
        tab += _up(bb * bl, 16) + _up(mloc * R, 16)
        bl = mloc * bl // nn
    return (_up(buf[0], 128) + _up(buf[1], 128) + stages * _up(slot, 128)
            + _up(cbuf, 128) + _up(tab * 4, 128))


@dataclasses.dataclass(frozen=True)
class ChainGeometry:
    """One fused-chain launch: rows per block, m_{d-1} values per block
    (g), m_{d-2} values per block (g2), the widest column chunk of a staged
    core, shared memory per block, the grid (row tiles, g groups, g2
    groups), and ns, ms and ranks as the C arrays the launch passes;
    ``stages`` ring slots (1: no chunk staged ahead)."""
    bb: int
    g: int
    g2: int
    ncc: int
    stages: int
    smem: int
    grid: tuple[int, int, int]
    c_dims: tuple = dataclasses.field(compare=False, repr=False)


def _group_sizes(m: int) -> list[int]:
    """Group sizes that cut m into 1, 2, … groups (balanced), largest
    first."""
    return sorted({-(-m // c) for c in range(1, m + 1)}, reverse=True)


@functools.lru_cache(maxsize=None)
def chain_geometry(B: int, dims: tuple, act_bytes: int, w_bytes: int,
                   sm_count: int, smem_bytes: int) -> ChainGeometry:
    """Tiles of one fused-chain launch (memoized: a decode step asks for
    the same few every time, and the C arrays of its dims are built once).

    A block owns a tile of bb rows and a group of g values of the first
    step's mode m_{d-1}, with no recompute; where those blocks leave SMs
    idle it also takes a group of g2 values of m_{d-2}, and every block of
    the same rows and g group then recomputes the first step.  Of the
    tiles whose grid gives 90% of the SMs a block and whose block fits
    ``smem_bytes``, it takes the fewest g2 groups (the least recompute),
    then the widest g (y written in longer runs), then the most rows (each
    core slice read once for more rows).  At 256 rows that is g = m_{d-1},
    g2 = m_{d-2} and 2 rows (128 blocks); at 4 rows, 1 row, g = 1 and g2 =
    2 (128 blocks).  When no tile reaches 90%, the smallest (1, 1, 1).
    Core columns are staged in chunks of at most ncc columns, the widest
    core slice cut into as few even chunks as fit (a whole slice per chunk
    wherever it does), in a ring of two slots, or of one where two do not
    fit even at 16 columns.  Raises when even the smallest block does not
    fit."""
    ns, ms, ranks = (tuple(int(v) for v in a) for a in dims)
    target = sm_count * 9 // 10

    def chunking(bb: int, g: int, g2: int) -> tuple[int, int] | None:
        """(chunk width, ring slots) at which the block fits, or None: two
        slots before one; the widest core slice cut into 1, 2, … chunks of
        a multiple of 16 columns."""
        widest = max(mloc * R for _, R, mloc, _ in
                     _chain_steps(ns, ms, ranks, g, g2))
        for stages in (2, 1):
            for cuts in range(1, -(-widest // 16) + 1):
                ncc = _up(-(-widest // cuts), 16)
                if chain_smem_bytes(ns, ms, ranks, bb, g, g2, ncc, stages,
                                    act_bytes, w_bytes) <= smem_bytes:
                    return ncc, stages
        return None

    def tiles():
        for g2 in _group_sizes(ms[-2]):
            for g in _group_sizes(ms[-1]):
                groups = -(-ms[-1] // g) * -(-ms[-2] // g2)
                for bb in range(min(B, MAX_CHAIN_TILE), 0, -1):
                    if -(-B // bb) * groups >= target:
                        yield bb, g, g2
        yield 1, 1, 1

    for bb, g, g2 in tiles():
        fit = chunking(bb, g, g2)
        if fit:
            break
    else:
        need = chain_smem_bytes(ns, ms, ranks, 1, 1, 1, 16, 1, act_bytes,
                                w_bytes)
        raise ValueError(
            f"a fused-chain block of one row (ns={ns}, ms={ms}, "
            f"ranks={ranks}) needs {need} bytes of shared memory, "
            f"{smem_bytes} available")
    grid = (-(-B // bb), -(-ms[-1] // g), -(-ms[-2] // g2))
    if max(grid[1:]) > 65535:
        raise ValueError(f"fused-chain grid {grid} exceeds 65535 blocks "
                         f"per axis")
    ncc, stages = fit
    ints = ctypes.c_int * (len(ns) + 1)
    return ChainGeometry(bb, g, g2, ncc, stages, chain_smem_bytes(
        ns, ms, ranks, bb, g, g2, ncc, stages, act_bytes, w_bytes), grid,
        (ints(*ns), ints(*ms), ints(*ranks)))


def _check_chain(x, packed, dims, weight_dtype, scales=None) -> None:
    ns, ms, ranks = dims
    d = len(ns)
    if len(ms) != d or len(ranks) != d + 1:
        raise ValueError(f"inconsistent chain dims {dims}")
    if ranks[0] != 1 or ranks[-1] != 1:
        raise ValueError(f"the chain's boundary ranks must be 1, got "
                         f"{tuple(ranks)}")
    if not 2 <= d <= MAX_CHAIN_DEPTH or len(packed) != d:
        raise ValueError(
            f"the fused chain takes 2 <= d <= {MAX_CHAIN_DEPTH} packed "
            f"cores matching dims; got {len(packed)} cores for d={d}")
    if x.dtype not in _ACT_SUFFIX:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    N = 1
    for n in ns:
        N *= int(n)
    if x.dim() != 2 or x.shape[1] != N:
        raise ValueError(f"x must be [B, {N}] for ns={tuple(ns)}, got "
                         f"{tuple(x.shape)}")
    _check_device(x, [("x", x)] + [(f"packed[{j}]", p)
                                   for j, p in enumerate(packed)])
    want = x.dtype if weight_dtype is None else weight_dtype
    for j, p in enumerate(packed):
        t = d - 1 - j
        shape = (ns[t] * ranks[t + 1], ms[t] * ranks[t])
        if tuple(p.shape) != shape:
            raise ValueError(
                f"packed[{j}] (core {t + 1}) has shape {tuple(p.shape)}, "
                f"expected {shape}")
        if p.dtype != want:
            raise TypeError(f"packed[{j}] must be {want}, got {p.dtype}")
    if scales is not None:
        _check_scales(scales, x, d, "execution order")


def _launch_chain(name: str, x, packed, scales, dims):
    ns, ms, ranks = (tuple(int(v) for v in a) for a in dims)
    d = len(ns)
    B = x.shape[0]
    M = 1
    for m in ms:
        M *= m
    y = torch.empty((B, M), dtype=x.dtype, device=x.device)
    if B == 0:
        return y
    if max(x.numel(), y.numel()) >= 2 ** 31:
        raise ValueError(f"{name}: x and y must each hold fewer than 2^31 "
                         f"values (the kernel's offsets are int)")
    spec = hw.device_spec(x.device)
    geo = chain_geometry(B, (ns, ms, ranks), x.element_size(),
                         packed[0].element_size(), spec.sm_count,
                         spec.smem_per_block)
    tables = _chain_tables_on(x.device, (ns, ms, ranks), geo,
                              x.element_size())
    fn = getattr(_lib(), f"{name}_{_ACT_SUFFIX[x.dtype]}")
    stream = torch.cuda.current_stream(x.device).cuda_stream
    args = [x.data_ptr(), (ctypes.c_void_p * d)(*[p.data_ptr()
                                                  for p in packed]),
            *geo.c_dims, d]
    if scales is not None:
        args.append(scales.data_ptr())
    with torch.cuda.device(x.device):
        err = fn(*args, tables.data_ptr(), y.data_ptr(), B, geo.bb, geo.g,
                 geo.g2, geo.ncc, geo.stages, geo.smem, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)
    return y


def tt_fused_chain(x: torch.Tensor, packed, dims) -> torch.Tensor:
    """Fused TT chain of any depth d ≥ 2 in one launch.  ``x [B, N]`` →
    ``y [B, M]`` in ``x.dtype`` (float32 or bfloat16).

    ``packed[j] = P_{d-j}`` are the packed cores in execution order (core d
    first), each ``[n_t·r_t, m_t·r_{t-1}]`` in ``x.dtype``; ``dims = (ns,
    ms, ranks)``.  The tiles of the launch come from
    ``chain_geometry``."""
    _check_chain(x, packed, dims, None)
    if x.device.type == "cpu":
        return tt_fused_chain_ref(x, packed, dims)
    if x.device.type != "cuda":
        raise ValueError(f"tt_fused_chain runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_chain("tt_fused_chain", x, packed, None, dims)


def tt_fused_chain_int8(x: torch.Tensor, packed, scales: torch.Tensor,
                        dims) -> torch.Tensor:
    """int8 fused TT chain: ``packed`` are int8 packed cores in execution
    order and ``scales [d]`` their fp32 scales in the same order, a device
    tensor on ``x``'s device.  Each step's fp32 output is multiplied by its
    core's scale."""
    _check_chain(x, packed, dims, torch.int8, scales)
    if x.device.type == "cpu":
        return tt_fused_chain_ref(x, packed, dims, scales)
    if x.device.type != "cuda":
        raise ValueError(f"tt_fused_chain_int8 runs on cuda or cpu, not "
                         f"{x.device}")
    return _launch_chain("tt_fused_chain_int8", x, packed, scales, dims)


# ---------------------------------------------------------------------------
# one step on the raw core
# ---------------------------------------------------------------------------

def _odd_units(length: int, nbytes: int) -> int:
    """Elements of a row stride of at least ``length`` elements of
    ``nbytes`` each: an odd number of 16-byte units (the source's
    ``odd_units``)."""
    q = -(-length * nbytes // 16)
    return (q if q % 2 else q + 1) * 16 // nbytes


def step_kv(n: int, r1: int, tm: int, act_bytes: int) -> int:
    """The step kernel's inner product (the source's ``KV``): r1 values of
    X and G per shared load, a 16-byte vector of activations, when r1 is a
    multiple of it; 2 when r1 = 1 (two n values of X per load, ``STEP_RJ``
    consecutive m of G per load), which needs whole groups of them in the
    tile and an even n; else 1."""
    kv = 16 // act_bytes
    if r1 % kv == 0:
        return kv
    return 2 if r1 == 1 and tm % STEP_RJ == 0 and n % 2 == 0 else 1


def _step_slot(r1: int, tb: int, tm: int, tr: int, nc: int, kv: int,
               act_bytes: int, w_bytes: int) -> int:
    """Bytes of one ring slot of the step kernel: G's chunk ``[tr][nc]
    [tm]`` of padded columns (``kv > 2``) or of dense runs with 8 (int8:
    16) values between r0 values, then X's chunk ``[tb][ldx]``."""
    if kv > 2:
        s2 = nc * tm * _odd_units(r1, w_bytes)
    else:
        s2 = _up(nc * tm * r1, 16 // w_bytes) + max(8, 16 // w_bytes)
    slot_g = _up(tr * s2 * w_bytes, 128)
    ldx = _odd_units(nc * r1, act_bytes)
    return slot_g + _up(tb * ldx * act_bytes, 128)


def step_smem_bytes(n: int, r1: int, tb: int, tm: int, tr: int, nc: int,
                    kv: int, act_bytes: int, w_bytes: int) -> int:
    """Shared memory of one step block: a ring of ``STEP_STAGES`` slots
    (fewer when n has fewer chunks), whose bytes then hold the partial
    output tiles of the reduction groups, at most one per warp (a warp
    adds its own groups by shuffles).  The layout of ``csrc/tt_step.cu``'s
    ``make_geo``, which refuses a launch whose byte count differs."""
    slot = _step_slot(r1, tb, tm, tr, nc, kv, act_bytes, w_bytes)
    TB = tb // STEP_RB
    TJ = _pow2_at_least(-(-tm * tr // STEP_RJ), 1)
    groups = min(max(1, STEP_THREADS // (TB * TJ)), STEP_THREADS // 32)
    return max(min(STEP_STAGES, -(-n // nc)) * slot,
               groups * tb * tm * tr * 4)


def _step_columns(m: int, r0: int, tj: int) -> tuple[int, int]:
    """(m values, r0 values) of a block tile about ``tj`` columns wide:
    as much of m as fits (its runs are contiguous in the core), then r0."""
    tm = min(m, tj)
    return tm, min(r0, max(1, tj // tm))


@dataclasses.dataclass(frozen=True)
class StepGeometry:
    """One step launch: the block tile (b rows, m values, r0 values), n
    values per staged chunk, r1 values per shared load, shared memory per
    block and the grid (column tiles, b tiles)."""
    tb: int
    tm: int
    tr: int
    nc: int
    kv: int
    smem: int
    grid: tuple[int, int]


@functools.lru_cache(maxsize=None)
def step_geometry(r0: int, n: int, m: int, r1: int, b: int, act_bytes: int,
                  w_bytes: int, sm_count: int, smem_bytes: int
                  ) -> StepGeometry:
    """Tiles of one step launch (memoized: a decode step asks for the same
    few every time).

    * The block tile is tb rows of b by tm·tr columns (``_step_columns``),
      tb and the column width each one of ``STEP_TILES`` (tb at most the
      power of two covering b).  It is the largest tile whose grid still
      gives 90% of the SMs a block (ties: the wider one, so that G's runs
      are longer); when no tile does, the one with the most blocks.  At 4
      rows that is 128–344 blocks for every full-width step; at prefill
      32×64 or 64×64 tiles.
    * The block's threads are (tb/4)×(columns/4) register tiles of 4×4;
      the rest of its 256 threads split the reduction.
    * The inner product (``step_kv``) follows from r1 and the tile.
    * n is staged in chunks of nc values: all of n when one ring slot of
      it stays within ``STEP_SLOT_BYTES``, else the largest multiple of 16
      that does; then smaller until the block fits ``smem_bytes`` (kept
      even under ``kv = 2``).  Raises when even the smallest chunk does
      not fit, or when the b tiles exceed the grid's 65535."""
    target = sm_count * 9 // 10
    best = None
    for tb in STEP_TILES:
        if tb > _pow2_at_least(b, STEP_RB):
            continue
        for tj in STEP_TILES:
            if tj > _pow2_at_least(m * r0, STEP_RJ):
                continue
            tm, tr = _step_columns(m, r0, tj)
            blocks = -(-b // tb) * -(-m // tm) * -(-r0 // tr)
            tile = tb * tm * tr
            key = ((True, tile, tm * tr) if blocks >= target
                   else (False, blocks, tile))
            if best is None or key > best[0]:
                best = (key, tb, tm, tr)
    _, tb, tm, tr = best
    kv = step_kv(n, r1, tm, act_bytes)

    def price(nc: int) -> int:
        return step_smem_bytes(n, r1, tb, tm, tr, nc, kv, act_bytes,
                               w_bytes)

    nc = n
    while nc > 16 and _step_slot(r1, tb, tm, tr, nc, kv, act_bytes,
                                 w_bytes) > STEP_SLOT_BYTES:
        nc = (nc - 1) // 16 * 16
    least = 2 if kv == 2 else 1
    while nc > least and price(nc) > smem_bytes:
        nc = nc - 16 if nc > 16 else nc - least
    if price(nc) > smem_bytes:
        raise ValueError(
            f"a step block of {nc} n value(s) (r0={r0}, m={m}, r1={r1}) "
            f"needs {price(nc)} bytes of shared memory, {smem_bytes} "
            f"available")
    grid = (-(-m // tm) * -(-r0 // tr), -(-b // tb))
    if grid[1] > 65535:
        raise ValueError(f"step grid {grid} exceeds 65535 blocks in b")
    return StepGeometry(tb, tm, tr, nc, kv, price(nc), grid)


def _check_step(G, X, weight_dtype, scale=None) -> None:
    if X.dtype not in _ACT_SUFFIX:
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if G.dim() != 4 or X.dim() != 3 or X.shape[1] != G.shape[1] or \
            X.shape[2] != G.shape[3]:
        raise ValueError(
            f"expected G [r0, n, m, r1] and X [b, n, r1], got "
            f"{tuple(G.shape)} and {tuple(X.shape)}")
    want = X.dtype if weight_dtype is None else weight_dtype
    if G.dtype != want:
        raise TypeError(f"G must be {want}, got {G.dtype}")
    _check_device(X, [("X", X), ("G", G)])
    if scale is not None:
        _check_scales(scale, X, 1, "the core's scale")


def _launch_step(name: str, G, X, scale):
    r0, n, m, r1 = (int(v) for v in G.shape)
    b = X.shape[0]
    out = torch.empty((m, b, r0), dtype=torch.float32, device=X.device)
    if out.numel() == 0:
        return out
    if max(G.numel(), X.numel(), out.numel()) >= 2 ** 31:
        raise ValueError(f"{name}: G, X and out must each hold fewer than "
                         f"2^31 values (the kernel's offsets are int)")
    spec = hw.device_spec(X.device)
    geo = step_geometry(r0, n, m, r1, b, X.element_size(), G.element_size(),
                        spec.sm_count, spec.smem_per_block)
    fn = getattr(_lib(), f"{name}_{_ACT_SUFFIX[X.dtype]}")
    stream = torch.cuda.current_stream(X.device).cuda_stream
    ptrs = [G.data_ptr(), X.data_ptr()]
    if scale is not None:
        ptrs.append(scale.data_ptr())
    with torch.cuda.device(X.device):
        err = fn(*ptrs, out.data_ptr(), r0, n, m, r1, b, geo.tb, geo.tm,
                 geo.tr, geo.nc, geo.kv, geo.smem, stream)
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _count(name)
    return out


def tt_step(G: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One TT step on the raw core: ``out[m, b, r0] = Σ_{n, r1}
    G[r0, n, m, r1]·X[b, n, r1]``, fp32 out.  ``G`` is the core as stored,
    in ``X.dtype`` (float32 or bfloat16)."""
    _check_step(G, X, None)
    if X.device.type == "cpu":
        return tt_step_ref(G, X)
    if X.device.type != "cuda":
        raise ValueError(f"tt_step runs on cuda or cpu, not {X.device}")
    return _launch_step("tt_step", G, X, None)


def tt_step_int8(G: torch.Tensor, X: torch.Tensor, scale: torch.Tensor
                 ) -> torch.Tensor:
    """int8 TT step: ``G`` holds int8 codes and ``scale`` (one fp32 value,
    a device tensor on ``X``'s device) its scale; the sum is multiplied by
    it."""
    _check_step(G, X, torch.int8, scale)
    if X.device.type == "cpu":
        return tt_step_ref(G, X, scale)
    if X.device.type != "cuda":
        raise ValueError(f"tt_step_int8 runs on cuda or cpu, not "
                         f"{X.device}")
    return _launch_step("tt_step_int8", G, X, scale)
