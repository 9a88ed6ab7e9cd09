"""Generation-based durable array store (DESIGN.md §13), the reference's
``core.durable`` (numpy and the standard library), with bf16 leaves
handled without ``ml_dtypes``.

A *generation* is one committed directory

    <root>/<prefix>_<NNNNNNNN>/
        arrays.bin      raw array bytes, streamed in bounded chunks
        manifest.json   schema version + per-array index (dtype, shape,
                        byte offset, length, crc32) + the non-array tree

written with the commit protocol a ``kill -9`` cannot tear:

  1. everything lands in a ``<final>.tmp.<pid>`` sibling first,
  2. ``arrays.bin`` and ``manifest.json`` are ``fsync``ed,
  3. the temp dir is atomically renamed onto the final name,
  4. the parent directory is ``fsync``ed so the rename itself is durable.

A crash before (3) leaves only a ``.tmp`` dir, which readers never list;
a crash after (4) leaves a fully-committed generation.  Torn *content*
(truncation, bit rot) is caught at read time: every array carries a
crc32 in the manifest, verified while streaming, and
:func:`load_latest_good` walks generations newest-first until one loads
clean, so a reader observes either a fully-committed generation or a
clear :class:`CorruptGenerationError`, never a torn state.

An array is a numpy array or a torch tensor.  A ``torch.bfloat16``
tensor (the port's caches at full width; numpy has no bf16) is written as
its raw 2-byte payload under the manifest dtype name ``"bfloat16"``, the
bytes and the name the reference writes for an ``ml_dtypes`` bf16 leaf,
so each package reads the other's generations.  A ``"bfloat16"`` leaf
reads back as a ``torch.bfloat16`` tensor, bit for bit; every other leaf
as a numpy array.  Arrays are read and written through ``uint8`` views in
``CHUNK_BYTES`` slabs, so peak memory stays bounded by the chunk size.
"""
from __future__ import annotations

import json
import os
import shutil
import time
import zlib

import numpy as np
import torch

# Bumped when the on-disk layout changes; readers reject other schemas
# with a clear error instead of misinterpreting bytes.
DURABLE_SCHEMA = 1

# Streaming slab size for both read and write paths.
CHUNK_BYTES = 1 << 20

# the manifest name of a bf16 leaf, stored as its raw 2-byte payload
BF16 = "bfloat16"


class CorruptGenerationError(RuntimeError):
    """A committed generation failed validation (truncated file, checksum
    mismatch, unreadable or wrong-schema manifest)."""


def resolve_dtype(name: str) -> np.dtype:
    """The numpy dtype that holds a leaf's bytes, from its manifest name:
    ``uint16`` for ``"bfloat16"`` (read back as ``torch.bfloat16``,
    :func:`host_array`)."""
    if name == BF16:
        return np.dtype(np.uint16)
    try:
        return np.dtype(name)
    except TypeError:
        raise CorruptGenerationError(
            f"unknown array dtype {name!r} in manifest") from None


def host_array(raw: np.ndarray, name: str):
    """A leaf read as ``raw`` (``resolve_dtype(name)``) in the caller's
    type: a ``torch.bfloat16`` tensor for ``"bfloat16"``, else ``raw``."""
    if name == BF16:
        return torch.from_numpy(raw.view(np.int16)).view(torch.bfloat16)
    return raw


def raw_array(a) -> tuple[np.ndarray, str]:
    """(a numpy array holding ``a``'s bytes, its manifest dtype name): a
    torch tensor goes to the host, a bf16 one as its 2-byte payload
    under ``"bfloat16"``."""
    if isinstance(a, torch.Tensor):
        t = a.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), BF16
        return t.numpy(), t.numpy().dtype.name
    a = np.asarray(a)
    return a, a.dtype.name


def fsync_dir(path: str) -> None:
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def _flat_bytes(a: np.ndarray) -> np.ndarray:
    """A flat uint8 view of ``a`` (0-d and empty arrays included)."""
    return np.ascontiguousarray(a).reshape(-1).view(np.uint8)


def write_arrays(dirpath: str, arrays: dict,
                 chunk_bytes: int = CHUNK_BYTES) -> dict:
    """Stream ``arrays`` into ``<dirpath>/arrays.bin`` in ``chunk_bytes``
    slabs, fsync it, and return the manifest index
    ``{key: {dtype, shape, offset, nbytes, crc32}}``."""
    index: dict[str, dict] = {}
    offset = 0
    with open(os.path.join(dirpath, "arrays.bin"), "wb") as f:
        for key in sorted(arrays):
            a, name = raw_array(arrays[key])
            flat = _flat_bytes(a)
            crc = 0
            for i in range(0, flat.nbytes, chunk_bytes):
                chunk = flat[i:i + chunk_bytes].tobytes()
                f.write(chunk)
                crc = zlib.crc32(chunk, crc)
            index[key] = {"dtype": name, "shape": list(a.shape),
                          "offset": offset, "nbytes": int(flat.nbytes),
                          "crc32": crc}
            offset += flat.nbytes
        f.flush()
        os.fsync(f.fileno())
    return index


def read_arrays(bin_path: str, index: dict, verify: bool = True,
                chunk_bytes: int = CHUNK_BYTES) -> dict:
    """Stream arrays back from ``bin_path`` per the manifest ``index``,
    verifying each crc32 as the bytes go by.  Truncation and corruption
    raise :class:`CorruptGenerationError` naming the offending array."""
    out: dict = {}
    try:
        f = open(bin_path, "rb")
    except OSError as e:
        raise CorruptGenerationError(f"{bin_path}: unreadable ({e})")
    with f:
        size = os.fstat(f.fileno()).st_size
        for key in sorted(index):
            meta = index[key]
            end = meta["offset"] + meta["nbytes"]
            if end > size:
                raise CorruptGenerationError(
                    f"{bin_path}: array {key!r} extends past end of file "
                    f"(needs bytes [{meta['offset']}, {end}), file has "
                    f"{size} — truncated write)")
            a = np.empty(tuple(meta["shape"]),
                         dtype=resolve_dtype(meta["dtype"]))
            dst = memoryview(a.reshape(-1).view(np.uint8))
            f.seek(meta["offset"])
            crc = 0
            got = 0
            while got < meta["nbytes"]:
                n = f.readinto(dst[got:got + chunk_bytes])
                if not n:
                    raise CorruptGenerationError(
                        f"{bin_path}: short read on array {key!r}")
                crc = zlib.crc32(dst[got:got + n], crc)
                got += n
            if verify and crc != meta["crc32"]:
                raise CorruptGenerationError(
                    f"{bin_path}: checksum mismatch on array {key!r} "
                    f"(stored {meta['crc32']:#x}, computed {crc:#x} — "
                    f"corrupted content)")
            out[key] = host_array(a, meta["dtype"])
    return out


# --------------------------------------------------------------- generations
def _gen_dir(root: str, gen: int, prefix: str) -> str:
    return os.path.join(root, f"{prefix}_{gen:08d}")


def committed_generations(root: str, prefix: str = "gen") -> list[int]:
    """Generation numbers with a committed manifest, sorted ascending.
    ``.tmp`` leftovers from crashed writes are invisible by construction."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if not name.startswith(prefix + "_") or ".tmp" in name:
            continue
        tail = name[len(prefix) + 1:]
        if tail.isdigit() and os.path.exists(
                os.path.join(root, name, "manifest.json")):
            out.append(int(tail))
    return sorted(out)


def write_generation(root: str, tree, arrays: dict, *, prefix: str = "gen",
                     extra: dict | None = None,
                     chunk_bytes: int = CHUNK_BYTES) -> int:
    """Commit the next generation under ``root`` (temp + fsync + atomic
    rename + parent fsync).  ``tree`` is the JSON-serializable non-array
    payload; ``arrays`` the leaves it references.  Returns the generation
    number."""
    os.makedirs(root, exist_ok=True)
    gens = committed_generations(root, prefix)
    gen = (gens[-1] if gens else 0) + 1
    final = _gen_dir(root, gen, prefix)
    tmp = final + f".tmp.{os.getpid()}"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    try:
        index = write_arrays(tmp, arrays, chunk_bytes)
        manifest = {"schema": DURABLE_SCHEMA, "generation": gen,
                    "time": time.time(), "arrays": index, "tree": tree,
                    "extra": extra or {}}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
    except BaseException:
        shutil.rmtree(tmp, ignore_errors=True)
        raise
    fsync_dir(root)
    return gen


def load_generation(root: str, gen: int, *, prefix: str = "gen",
                    verify: bool = True) -> tuple[object, dict, dict]:
    """Load one committed generation → (tree, arrays, manifest), verifying
    every checksum.  Raises :class:`CorruptGenerationError` on any damage."""
    d = _gen_dir(root, gen, prefix)
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, json.JSONDecodeError, UnicodeDecodeError) as e:
        raise CorruptGenerationError(f"{d}: unreadable manifest ({e})")
    schema = manifest.get("schema") if isinstance(manifest, dict) else "?"
    if schema != DURABLE_SCHEMA:
        raise CorruptGenerationError(
            f"{d}: manifest schema {schema!r} != {DURABLE_SCHEMA} (written "
            f"by an incompatible version)")
    arrays = read_arrays(os.path.join(d, "arrays.bin"), manifest["arrays"],
                         verify=verify)
    return manifest["tree"], arrays, manifest


def load_latest_good(root: str, *, prefix: str = "gen"
                     ) -> tuple[int, object, dict, dict, list[str]]:
    """Newest generation that loads clean → (gen, tree, arrays, manifest,
    skipped) where ``skipped`` describes every newer corrupt generation
    that was passed over.  Raises FileNotFoundError when no generation is
    committed and :class:`CorruptGenerationError` when all are damaged."""
    gens = committed_generations(root, prefix)
    if not gens:
        raise FileNotFoundError(f"no committed generations under {root}")
    skipped: list[str] = []
    for g in reversed(gens):
        try:
            tree, arrays, manifest = load_generation(root, g, prefix=prefix)
            return g, tree, arrays, manifest, skipped
        except CorruptGenerationError as e:
            skipped.append(str(e))
    raise CorruptGenerationError(
        f"every generation under {root} is corrupt:\n  "
        + "\n  ".join(skipped))


def prune_generations(root: str, keep: int = 3, *,
                      prefix: str = "gen") -> None:
    for g in committed_generations(root, prefix)[:-keep]:
        shutil.rmtree(_gen_dir(root, g, prefix), ignore_errors=True)
