"""Paged KV-cache block pool: the host-side half of the paged cache (a copy
of ``pages_for``, ``PagePool``, ``KVSnapshot``, ``SnapshotStore`` and
``PrefixIndex`` from ``repro.rollout.kvcache``).

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
falls back to token replay, which gives the same tokens, recomputed. With
the prefix cache on, a preempted row keeps its pages in the pool instead,
and the store is a SPILL tier: it sees pages only when the pool itself is
under pressure.

``PrefixIndex`` — a per-adapter radix trie over page-aligned token
prefixes. Every installed prompt inserts its FULL pages (each node is one
page worth of tokens and holds its own refcount on the page) plus its
partial tail page, and a new request walks its longest indexed prefix,
retains those pages and prefills only the suffix. Indexed pages are never
written: decode writes land at positions past the prompt, and the engine
forks (copy-on-write) any page with refcount > 1 before writing into it.

The pool is plain host bookkeeping — device page contents live in the
engine's cache dict (``kp``/``vp``: ``[L, n_pages+1, page, KVH, hd]``;
physical page ``n_pages`` is a scratch page that sentinel block-table
entries point at, so frozen-lane writes and masked reads land somewhere
harmless).
"""
from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, List, Optional

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
    numpy array): anything with ``.shape`` and ``.nbytes``. The engine
    keeps CPU tensors in the cache's dtypes, so that a bf16 ``conv`` (numpy
    has no bf16) restores bit for bit; ``nbytes`` counts all four fields
    against the store's budget."""
    pos: int                       # materialized cache entries
    cur: int                       # pending token (== row.gen[-1])
    kpages: Optional[object] = None   # [L_attn, n_pg, page, KVH, hd]
    vpages: Optional[object] = None
    ssm: Optional[object] = None      # [L_ssm, H, N, P] fp32 (this row)
    conv: Optional[object] = None     # [L_ssm, conv_dim, W-1] model dtype

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


class _TrieNode:
    __slots__ = ("children", "page", "parent", "key", "stamp")

    def __init__(self, parent: Optional["_TrieNode"] = None,
                 key=None, page: int = -1):
        self.children: Dict[tuple, "_TrieNode"] = {}
        self.page = page          # physical page id this node retains
        self.parent = parent
        self.key = key            # edge label: tuple of page_size tokens
        self.stamp = 0            # LRU clock at last touch


class PrefixIndex:
    """Per-adapter radix index over page-aligned token prefixes.

    Each trie edge is one page worth of tokens (a tuple of ``page_size``
    ints); the node at the end of the edge retains exactly one reference on
    the physical page holding that chunk's K/V. ``insert`` dedups against
    existing nodes (a sibling inserting an already-indexed prefix retains
    nothing new), ``match`` walks the longest indexed prefix, and
    ``pop_lru`` / ``invalidate`` hand back page ids for the CALLER to
    release: every ``PagePool`` mutation stays on the engine thread. The
    lock guards the trie alone, so that another thread may probe it while
    the engine thread inserts or evicts. (It is named apart from the JAX
    package's ``_lock``: the repo's lock analyzer names locks by class and
    attribute.)
    """

    def __init__(self, page_size: int):
        if page_size < 1:
            raise ValueError("page_size must be >= 1")
        self.page_size = int(page_size)
        self._trie_lock = threading.Lock()   # guards: _roots/_clock/_held
        self._roots: Dict[object, _TrieNode] = {}
        self._clock = 0
        self._held = 0                  # pages currently retained by nodes

    # -- introspection ---------------------------------------------------
    @property
    def held_pages(self) -> int:
        with self._trie_lock:
            return self._held

    def refcounts(self) -> Dict[int, int]:
        """Page id -> number of index nodes retaining it (for the engine's
        page-invariant checker)."""
        out: Dict[int, int] = {}
        with self._trie_lock:
            for root in self._roots.values():
                stack = list(root.children.values())
                while stack:
                    nd = stack.pop()
                    out[nd.page] = out.get(nd.page, 0) + 1
                    stack.extend(nd.children.values())
        return out

    # -- helpers ---------------------------------------------------------
    def _chunks(self, tokens) -> List[tuple]:
        p = self.page_size
        n = len(tokens) // p
        return [tuple(int(t) for t in tokens[i * p:(i + 1) * p])
                for i in range(n)]

    # -- lifecycle -------------------------------------------------------
    def insert(self, adapter, tokens, pages: List[int],
               tail_page: Optional[int] = None) -> List[int]:
        """Index a prompt's FULL pages (``len(pages)`` must cover the
        page-aligned prefix of ``tokens``) plus, optionally, the PARTIAL
        tail page holding the remainder, keyed by the (shorter) remainder
        tuple, so that an exact-prompt sibling (GRPO group) can share the
        whole prompt including its last page and fork it copy-on-write at
        the first decode write. Returns the page ids newly referenced by the
        index: the caller must ``retain`` exactly those (the row already
        owns them, so rc >= 1 holds)."""
        chunks = self._chunks(tokens)[:len(pages)]
        rem = tuple(int(t) for t in tokens[len(chunks) * self.page_size:])
        newly: List[int] = []
        with self._trie_lock:
            self._clock += 1
            node = self._roots.setdefault(adapter, _TrieNode())
            for i, ch in enumerate(chunks):
                nxt = node.children.get(ch)
                if nxt is None:
                    nxt = _TrieNode(parent=node, key=ch, page=int(pages[i]))
                    node.children[ch] = nxt
                    newly.append(int(pages[i]))
                nxt.stamp = self._clock
                node = nxt
            if tail_page is not None and rem:
                nxt = node.children.get(rem)
                if nxt is None:
                    nxt = _TrieNode(parent=node, key=rem, page=int(tail_page))
                    node.children[rem] = nxt
                    newly.append(int(tail_page))
                nxt.stamp = self._clock
            self._held += len(newly)
        return newly

    def match_full(self, adapter, tokens):
        """Exact whole-sequence match (the GRPO-sibling fast path): every
        full chunk is indexed AND, for a sequence that is not page-aligned,
        a tail node holds the exact remainder. Returns ``(full_pages,
        tail_page)`` (``tail_page`` None when the sequence is page-aligned)
        or None. A hit installs with ZERO prefill writes: the row retains
        every page, recomputes only the final chunk for its first-token
        logits, and its first decode write forks the shared tail."""
        chunks = self._chunks(tokens)
        rem = tuple(int(t) for t in tokens[len(chunks) * self.page_size:])
        with self._trie_lock:
            node = self._roots.get(adapter)
            if node is None:
                return None
            self._clock += 1
            pages: List[int] = []
            for ch in chunks:
                nxt = node.children.get(ch)
                if nxt is None:
                    return None
                nxt.stamp = self._clock
                pages.append(nxt.page)
                node = nxt
            if not rem:
                return (pages, None) if pages else None
            tail = node.children.get(rem)
            if tail is None:
                return None
            tail.stamp = self._clock
            return (pages, tail.page)

    def match(self, adapter, tokens, max_tokens: Optional[int] = None
              ) -> List[int]:
        """Longest indexed page-aligned prefix of ``tokens``: the page ids
        along the path, NOT retained (the engine retains them before any
        eviction can run; evictions also happen only on the engine thread).
        ``max_tokens`` caps the match (e.g. to ``len(seq) - 1`` so that at
        least one suffix token remains to prefill)."""
        chunks = self._chunks(tokens)
        if max_tokens is not None:
            chunks = chunks[:max(0, int(max_tokens)) // self.page_size]
        pages: List[int] = []
        with self._trie_lock:
            node = self._roots.get(adapter)
            if node is None:
                return []
            self._clock += 1
            for ch in chunks:
                nxt = node.children.get(ch)
                if nxt is None:
                    break
                nxt.stamp = self._clock
                pages.append(nxt.page)
                node = nxt
        return pages

    def pop_lru(self, n_pages: int) -> List[int]:
        """Remove up to ``n_pages`` least-recently-touched LEAF entries (an
        emptied parent becomes eligible next round) and return their page
        ids for the caller to release."""
        out: List[int] = []
        with self._trie_lock:
            while len(out) < n_pages:
                leaf = None
                for root in self._roots.values():
                    stack = list(root.children.values())
                    while stack:
                        nd = stack.pop()
                        if nd.children:
                            stack.extend(nd.children.values())
                        elif leaf is None or nd.stamp < leaf.stamp:
                            leaf = nd
                if leaf is None:
                    break
                del leaf.parent.children[leaf.key]
                out.append(leaf.page)
            self._held -= len(out)
        return out

    def invalidate(self, adapter=None) -> List[int]:
        """Drop one adapter's subtree (or everything when ``adapter`` is
        None) and return the page ids for the caller to release."""
        out: List[int] = []
        with self._trie_lock:
            if adapter is None:
                roots = list(self._roots.values())
                self._roots.clear()
            else:
                nd = self._roots.pop(adapter, None)
                roots = [nd] if nd is not None else []
            for root in roots:
                stack = list(root.children.values())
                while stack:
                    nd = stack.pop()
                    out.append(nd.page)
                    stack.extend(nd.children.values())
            self._held -= len(out)
        return out
