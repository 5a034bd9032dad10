"""Paged KV-cache block pool: the host-side half of the paged cache (a copy
of ``pages_for``, ``PagePool``, ``KVSnapshot`` and ``SnapshotStore`` from
``repro.rollout.kvcache``; its ``PrefixIndex`` belongs to the prefix cache,
which is not ported yet).

``PagePool`` — a fixed-size pool of ``n_pages`` KV pages of ``page_size``
tokens each, with a free list and per-page reference counts. Rows own
pages through per-slot block tables (the engine mirrors them host-side and
uploads a ``[slots, max_pages_per_row]`` int32 table to the device when
the topology changes). A page returns to the free list only when its last
owner releases it.

``KVSnapshot`` — a preempted row's device state copied to HOST memory: its
live KV pages (only ``ceil(pos/page_size)`` of them, never the ``max_len``
worst case), the cache position and the pending current token. The pages
are CPU tensors in the cache's dtype (numpy has no bfloat16); ``nbytes``
counts what the JAX package's numpy arrays of the same shape and dtype
count, so a snapshot budget means the same in both packages. Restoring
splices the pages back into freshly allocated pool pages and resumes
decode with the pending token: no prefill replay.

``SnapshotStore`` — byte-budgeted host arena for snapshots. A snapshot that
would exceed ``budget_bytes`` is DROPPED rather than stored; the row then
falls back to token replay, which gives the same tokens, recomputed.

The pool is plain host bookkeeping — device page contents live in the
engine's cache dict (``kp``/``vp``: ``[L, n_pages+1, page, KVH, hd]``;
physical page ``n_pages`` is a scratch page that sentinel block-table
entries point at, so frozen-lane writes and masked reads land somewhere
harmless).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np


def pages_for(tokens: int, page_size: int) -> int:
    """Pages needed to hold `tokens` cache entries."""
    if tokens <= 0:
        return 0
    return -(-int(tokens) // int(page_size))


class PagePool:
    """Fixed-size block-pool allocator with a free list and ref counts.

    Page ids are ``0 .. n_pages-1``; id ``n_pages`` is the SENTINEL (the
    device-side scratch page) and is never allocated. All methods are
    host-side and O(pages touched); the engine thread alone calls them.
    """

    def __init__(self, n_pages: int, page_size: int):
        if n_pages < 1:
            raise ValueError("page pool needs at least one page")
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.n_pages = n_pages
        self.page_size = page_size
        self.sentinel = n_pages
        self._free: List[int] = list(range(n_pages - 1, -1, -1))
        self._rc = np.zeros((n_pages,), np.int32)
        self.peak_used = 0            # high-water mark of pages in use

    # -- introspection ---------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.n_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return int(self._rc[page])

    @property
    def shared_pages(self) -> int:
        """Pages with more than one owner."""
        return int((self._rc > 1).sum())

    def check_invariants(self):
        """Free/used conservation, free pages unreferenced, used pages
        referenced, no duplicates on the free list."""
        assert len(set(self._free)) == len(self._free), "free-list dup"
        assert all(0 <= p < self.n_pages for p in self._free)
        free = set(self._free)
        for p in range(self.n_pages):
            if p in free:
                assert self._rc[p] == 0, f"page {p} free but referenced"
            else:
                assert self._rc[p] > 0, f"page {p} leaked (rc=0, not free)"
        assert self.used_pages + self.free_pages == self.n_pages

    # -- lifecycle -------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate `n` pages (rc=1 each) or None if the pool can't serve
        the whole request (all-or-nothing: a partially allocated row would
        deadlock against another partially allocated row)."""
        if n < 0:
            raise ValueError(n)
        if n > len(self._free):
            return None
        pages = [self._free.pop() for _ in range(n)]
        for p in pages:
            self._rc[p] = 1
        self.peak_used = max(self.peak_used, self.used_pages)
        return pages

    def retain(self, pages: List[int]):
        """Add one reference to each page (a second owner)."""
        for p in pages:
            if self._rc[p] <= 0:
                raise ValueError(f"retain of unallocated page {p}")
            self._rc[p] += 1

    def release(self, pages: List[int]):
        """Drop one reference per page; pages return to the free list at
        rc==0."""
        for p in pages:
            if self._rc[p] <= 0:
                raise ValueError(f"release of unallocated page {p}")
            self._rc[p] -= 1
            if self._rc[p] == 0:
                self._free.append(p)


@dataclass
class KVSnapshot:
    """One preempted row's cache state, host-side.

    ``pos`` cache entries are materialized (the prompt + all generated
    tokens EXCEPT the pending one); ``cur`` is the last accepted token, not
    yet fed through the model. Restoring installs (pages, pos, cur) and the
    next ordinary decode step continues the row exactly where an
    uninterrupted run would be. Each array field is a CPU tensor (or a
    numpy array): anything with ``.shape`` and ``.nbytes``."""
    pos: int                       # materialized cache entries
    cur: int                       # pending token (== row.gen[-1])
    kpages: Optional[object] = None   # [L_attn, n_pg, page, KVH, hd]
    vpages: Optional[object] = None
    ssm: Optional[object] = None      # recurrent state (families not ported)
    conv: Optional[object] = None

    @property
    def n_pages(self) -> int:
        return 0 if self.kpages is None else int(self.kpages.shape[1])

    @property
    def nbytes(self) -> int:
        return sum(int(a.nbytes) for a in
                   (self.kpages, self.vpages, self.ssm, self.conv)
                   if a is not None)


class SnapshotStore:
    """Byte-budgeted host arena for KV snapshots.

    ``budget_bytes == 0`` means unlimited. ``try_add`` REJECTS a snapshot
    that would exceed the budget (the caller falls back to token replay):
    rejecting the newcomer rather than evicting an older snapshot keeps the
    drop deterministic and never invalidates state another queued row
    already depends on."""

    def __init__(self, budget_bytes: int = 0):
        self.budget_bytes = int(budget_bytes)
        self.bytes_used = 0
        self.drops = 0            # snapshots rejected under pressure

    def try_add(self, snap: KVSnapshot) -> bool:
        need = snap.nbytes
        if self.budget_bytes and self.bytes_used + need > self.budget_bytes:
            self.drops += 1
            return False
        self.bytes_used += need
        return True

    def remove(self, snap: KVSnapshot):
        self.bytes_used -= snap.nbytes
        assert self.bytes_used >= 0
