"""Host-side block-paged KV-cache management (DESIGN.md §7), copied from
the reference's ``serving.paging`` (numpy and hashlib only).

The device side is a set of *arenas* — one per cache leaf and layer,
shaped ``[num_blocks + 1, block, ...]`` — plus a per-slot *block table*
``[num_slots, max_blocks] int32`` mapping logical token-blocks to arena
blocks (the extra arena block is a write sentinel: inactive slots and
unallocated table entries point at it, so masked decode steps and splice
padding never touch live storage).  This module owns everything the device
does NOT see: the free list, per-block reference counts, the content-hash
registry that enables prefix sharing, the LRU of retired-but-still-cached
blocks, and copy-on-write bookkeeping.

Every block is in exactly one of three states:

  free       — on the free list, content meaningless
  live       — refcount > 0; owned by one or more slots' block tables
  evictable  — refcount == 0 but *published* (content-hashed): the block
               still holds a reusable prompt prefix and is only reclaimed
               (LRU) when the free list runs dry

Prefix sharing is full-block granular: a block is published under the
chained hash of every token up to and including its own
(``chain_hashes``), so a hash hit guarantees the whole token prefix
matches, not just the block's own span.  Shared blocks are immutable —
a slot that must write into a shared (or published) block first asks
``cow()`` for a private replacement and the device copies content through
the gather(src-table)/scatter(dst-table) resume-prefill path
(``Model.prefill_resume``).
"""
from __future__ import annotations

import collections
import hashlib

import numpy as np


def logical_blocks(n_tokens: int, block: int) -> int:
    """Number of fixed-size blocks covering ``n_tokens`` positions."""
    if n_tokens < 0:
        raise ValueError("n_tokens must be >= 0")
    return -(-n_tokens // block)


def chain_hashes(tokens, block: int) -> list[bytes]:
    """Chained content hash of every *full* block of a token sequence.

    ``hashes[i]`` digests tokens ``[0, (i+1)*block)`` — a match therefore
    certifies the entire prefix, which is what makes full blocks safely
    shareable between requests."""
    toks = np.ascontiguousarray(np.asarray(tokens, np.int64).reshape(-1))
    out: list[bytes] = []
    h = b""
    for i in range(len(toks) // block):
        h = hashlib.sha256(
            h + toks[i * block:(i + 1) * block].tobytes()).digest()
        out.append(h)
    return out


class BlockAllocator:
    """Refcounted fixed-size block allocator with a content-hash registry.

    The device sentinel block is NOT managed here — the allocator hands out
    ids in ``[0, num_blocks)`` and the arenas are sized ``num_blocks + 1``.
    """

    def __init__(self, num_blocks: int, block_size: int):
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.num_blocks = num_blocks
        self.block = block_size
        self._free: list[int] = list(range(num_blocks - 1, -1, -1))
        self._ref = np.zeros(num_blocks, np.int64)
        self._hash_of: dict[int, bytes] = {}      # published block -> hash
        self._by_hash: dict[bytes, int] = {}      # hash -> published block
        # refcount-0 published blocks, LRU order (oldest first)
        self._evictable: collections.OrderedDict[int, None] = \
            collections.OrderedDict()
        # pending-shrink fence: when set, ids >= _target are never handed
        # out again; live ones drain through decref and the shrink
        # completes via finalize_shrink() (the scheduler slices the device
        # arenas in the same breath)
        self._target: int | None = None
        # fault injection (``serving.faults.run_with_faults`` sets it on a
        # FaultPlan's alloc_fail_steps): while set, the allocator reports
        # zero availability and prefix lookups miss, so admissions defer
        # exactly as under real pool exhaustion — no mid-admission
        # exception, nothing to roll back
        self.refuse_fresh = False

    # ------------------------------------------------------------- accounting
    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def cached_count(self) -> int:
        return len(self._evictable)

    @property
    def available(self) -> int:
        """Blocks an ``alloc()`` can currently produce (free + evictable).
        Zero while fault injection refuses fresh allocations."""
        if self.refuse_fresh:
            return 0
        return len(self._free) + len(self._evictable)

    @property
    def in_use(self) -> int:
        return int(np.count_nonzero(self._ref))

    @property
    def capacity(self) -> int:
        """Admission-visible pool size: the pending-shrink target when a
        resize is draining, else ``num_blocks`` — requests sized against
        the old capacity could never be admitted after the shrink lands."""
        return self._target if self._target is not None else self.num_blocks

    @property
    def pending_target(self) -> int | None:
        return self._target

    @property
    def shrink_ready(self) -> bool:
        """True when a pending shrink has drained (no live block at or
        above the fence) and :meth:`finalize_shrink` may run."""
        return (self._target is not None
                and not np.any(self._ref[self._target:]))

    def assert_quiescent(self) -> None:
        """Leak check for a drained scheduler: every block must be either
        free or retired-but-cached (refcount 0, published), and the three
        states must tile the pool exactly.  Raises AssertionError with the
        full ledger on any leak."""
        leaked = [int(b) for b in np.nonzero(self._ref)[0]]
        if leaked:
            raise AssertionError(
                f"leaked blocks (refcount > 0 after drain): "
                f"{[(b, int(self._ref[b])) for b in leaked]}")
        if self._free and min(self._free) < 0:
            raise AssertionError("negative id on the free list")
        if self.free_count + self.cached_count != self.num_blocks:
            raise AssertionError(
                f"block ledger does not tile the pool: free={self.free_count}"
                f" cached={self.cached_count} != total={self.num_blocks}")

    def refcount(self, bid: int) -> int:
        self._check(bid)
        return int(self._ref[bid])

    def _check(self, bid: int) -> None:
        if not 0 <= bid < self.num_blocks:
            raise ValueError(f"block id {bid} out of range")

    # ------------------------------------------------------------- lifecycle
    def alloc(self) -> int:
        """Take a private block (refcount 1), evicting the LRU published
        block if the free list is dry."""
        if self.refuse_fresh:
            raise RuntimeError("allocation refused (fault injection) — "
                               "admission must defer, not alloc")
        if self._free:
            bid = self._free.pop()
        elif self._evictable:
            bid, _ = self._evictable.popitem(last=False)
            del self._by_hash[self._hash_of.pop(bid)]
        else:
            raise RuntimeError("out of KV-cache blocks")
        self._ref[bid] = 1
        return bid

    def incref(self, bid: int) -> None:
        self._check(bid)
        if self._ref[bid] == 0:
            if bid not in self._evictable:
                raise RuntimeError(f"incref of free block {bid}")
            del self._evictable[bid]      # revived from the retired cache
        self._ref[bid] += 1

    def decref(self, bid: int) -> None:
        self._check(bid)
        if self._ref[bid] <= 0:
            raise RuntimeError(f"double free of block {bid}")
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            if self._target is not None and bid >= self._target:
                # draining a pending shrink: the id dies here instead of
                # returning to circulation
                if bid in self._hash_of:
                    del self._by_hash[self._hash_of.pop(bid)]
                return
            if bid in self._hash_of:      # published: keep content, evict LRU
                self._evictable[bid] = None
            else:
                self._free.append(bid)

    # --------------------------------------------------------- prefix registry
    def publish(self, bid: int, h: bytes) -> int:
        """Register a live block's content hash for sharing.  First writer
        wins: if the hash is already mapped (another block holds identical
        content, e.g. a COW copy) the existing mapping is kept and its
        block id returned."""
        self._check(bid)
        if self._ref[bid] <= 0:
            raise RuntimeError(f"publish of non-live block {bid}")
        if h in self._by_hash:
            return self._by_hash[h]
        if bid in self._hash_of:          # re-publish under a new hash
            del self._by_hash[self._hash_of[bid]]
        self._hash_of[bid] = h
        self._by_hash[h] = bid
        return bid

    def lookup(self, h: bytes) -> int | None:
        """Non-acquiring probe (no refcount change)."""
        return self._by_hash.get(h)

    def acquire(self, h: bytes) -> int | None:
        """Look a hash up and take a reference (reviving an evictable
        block).  Returns None on miss — including while fault injection
        refuses allocations, so an admission under injection defers
        cleanly instead of reaching ``cow()``/``alloc()``."""
        if self.refuse_fresh:
            return None
        bid = self._by_hash.get(h)
        if bid is None:
            return None
        self.incref(bid)
        return bid

    def cow(self, bid: int) -> int:
        """Copy-on-write: called by an owner about to *write into* logical
        content currently stored in ``bid``.  If the block is exclusively
        owned and unpublished the write is safe in place and ``bid`` is
        returned unchanged; otherwise a fresh private block is allocated,
        the caller's reference on ``bid`` is dropped, and the new id is
        returned (the device copies content via gather-src/scatter-dst)."""
        self._check(bid)
        if self._ref[bid] <= 0:
            raise RuntimeError(f"cow of non-live block {bid}")
        if self._ref[bid] == 1 and bid not in self._hash_of:
            return bid
        new = self.alloc()
        self.decref(bid)
        return new

    # ---------------------------------------------------------------- resize
    def resize(self, num_blocks: int) -> bool:
        """Live-resize the pool (Scheduler.resize drives this and reshapes
        the device arenas to match).  Growth applies immediately: new ids
        join the free list.  A shrink drops free and evictable ids at or
        above the new target at once and *fences* the rest — live blocks
        above the target drain through their normal decrefs and are never
        re-issued; call :meth:`finalize_shrink` once :attr:`shrink_ready`.
        Returns True when the resize is fully applied."""
        if num_blocks < 1:
            raise ValueError("num_blocks must be >= 1")
        if num_blocks >= self.num_blocks:
            if num_blocks > self.num_blocks:          # grow
                # append descending so pops hand out ascending ids, matching
                # the construction-time order
                self._free.extend(
                    range(num_blocks - 1, self.num_blocks - 1, -1))
                self._ref = np.concatenate(
                    [self._ref,
                     np.zeros(num_blocks - self.num_blocks, np.int64)])
                self.num_blocks = num_blocks
            if self._target is not None:
                # cancelling a pending shrink: ids dropped while the fence
                # was up (filtered free ids, decref'd-dead ids) return to
                # circulation so the ledger tiles the pool again
                have = (set(self._free) | set(self._evictable)
                        | {int(b) for b in np.nonzero(self._ref)[0]})
                self._free.extend(sorted(
                    set(range(self.num_blocks)) - have, reverse=True))
                self._target = None
            return True
        self._target = num_blocks
        self._free = [b for b in self._free if b < num_blocks]
        for bid in [b for b in self._evictable if b >= num_blocks]:
            del self._evictable[bid]
            del self._by_hash[self._hash_of.pop(bid)]
        if self.shrink_ready:
            self.finalize_shrink()
            return True
        return False

    def finalize_shrink(self) -> None:
        """Complete a drained shrink: truncate the refcount ledger to the
        fence.  The caller owns slicing the device arenas in lockstep."""
        if self._target is None:
            return
        if not self.shrink_ready:
            live = np.nonzero(self._ref[self._target:])[0] + self._target
            raise RuntimeError(
                f"shrink to {self._target} not drained: live ids "
                f"{[int(b) for b in live]}")
        self._ref = self._ref[:self._target]
        self.num_blocks = self._target
        self._target = None

    # -------------------------------------------------------------- snapshot
    def state(self) -> dict:
        """JSON-safe snapshot of the full ledger (free-list order and LRU
        order preserved — restore is deterministic)."""
        return {
            "num_blocks": self.num_blocks, "block": self.block,
            "free": [int(b) for b in self._free],
            "ref": [int(r) for r in self._ref],
            "published": [[int(b), h.hex()] for b, h in self._hash_of.items()],
            "evictable": [int(b) for b in self._evictable],
            "target": self._target,
        }

    @classmethod
    def from_state(cls, st: dict) -> "BlockAllocator":
        a = cls(int(st["num_blocks"]), int(st["block"]))
        a._free = [int(b) for b in st["free"]]
        a._ref = np.asarray(st["ref"], np.int64)
        a._hash_of = {int(b): bytes.fromhex(h) for b, h in st["published"]}
        a._by_hash = {h: b for b, h in a._hash_of.items()}
        a._evictable = collections.OrderedDict(
            (int(b), None) for b in st["evictable"])
        a._target = None if st.get("target") is None else int(st["target"])
        return a
