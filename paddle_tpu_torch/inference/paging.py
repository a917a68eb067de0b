"""Host-side KV-cache paging: page allocator + shared-prefix trie (the
port's own copy of paddle_tpu/inference/paging.py, same semantics).

The paged serving engine (``inference/engine.py``, ``paged=True``) carves
its KV cache into fixed-size pages and gives every decode slot a BLOCK
TABLE of physical page indices instead of a worst-case ``max_len`` cache
row. These two classes are the host-side half of that design, pure
Python:

- ``PageAllocator``: free list + per-page refcounts. A page is owned by
  every slot whose block table references it PLUS (for pages registered
  as a shared prefix) the prefix trie; it returns to the free list only
  when the last reference drops, so a retiring request never frees pages
  another slot still reads.

- ``PrefixTrie``: prefix cache over COMPLETE pages. A node keys on the
  exact ``page_size`` token ids of one page, children extend the prefix;
  each node pins one physical page (the trie holds its own allocator
  reference). Admission walks the prompt's complete pages through the
  trie — every match is a page of KV the engine neither recomputes nor
  duplicates — and registers the request's freshly computed complete
  pages for the next arrival. Eviction is LRU over leaves and never
  touches a page a live slot references (refcount > 1).

Safety invariant the engine builds on: a page registered in the trie
holds a COMPLETE page of prompt KV ([j*ps, (j+1)*ps) with (j+1)*ps <=
prompt_len), and decode only ever writes at positions >= prompt_len — so
shared pages are read-only for their whole life. The one write that would
land in a fully matched tail page goes through copy-on-write instead.

``chain_hashes`` and ``PrefixTrie.fingerprints`` use the same crc32 chain
as paddle_tpu, so fingerprints agree across the two packages and across
processes.
"""
from __future__ import annotations

import zlib
from typing import Dict, List, Optional, Tuple

__all__ = ["PageAllocator", "PrefixTrie", "pages_needed",
           "chain_hashes"]


def pages_needed(tokens: int, page_size: int) -> int:
    """Pages required to hold ``tokens`` cache positions."""
    return -(-int(tokens) // int(page_size))


def chain_hashes(tokens, page_size: int) -> List[int]:
    """crc32 chain hash of every COMPLETE page of ``tokens``: hash j
    folds page j's exact token tuple into hash j-1. The same fold
    :meth:`PrefixTrie.fingerprints` uses, so a router can hash an
    incoming prompt and intersect with the fingerprint set a replica
    reports — equal hashes <=> equal cached prefix chains, across
    processes (Python ``hash()`` is per-process salted; crc32 is not),
    without ever shipping token ids."""
    ps = int(page_size)
    if ps <= 0:
        return []
    out: List[int] = []
    h = 0
    for j in range(len(tokens) // ps):
        key = tuple(int(t) for t in tokens[j * ps:(j + 1) * ps])
        h = zlib.crc32(repr(key).encode(), h)
        out.append(h)
    return out


class PageAllocator:
    """Free-list page allocator with per-page reference counts.

    Pages are plain ints in [0, num_pages). ``alloc`` is all-or-nothing
    (a request either gets every page it needs or the pool state is
    untouched) so a failed admission never leaks a partial grant.
    """

    def __init__(self, num_pages: int):
        if num_pages < 1:
            raise ValueError("need at least one page")
        self.num_pages = int(num_pages)
        # pop() takes from the end: keep ascending ids popping first
        self._free: List[int] = list(range(self.num_pages - 1, -1, -1))
        self._refs: Dict[int, int] = {}

    # -- introspection ---------------------------------------------------
    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.num_pages - len(self._free)

    def refcount(self, page: int) -> int:
        return self._refs.get(page, 0)

    def check(self) -> None:
        """Invariant check (tests call it after churn): every page is
        either free exactly once or referenced, never both/neither."""
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page on the free list")
        held = set(self._refs)
        if free & held:
            raise AssertionError(f"pages both free and referenced: "
                                 f"{sorted(free & held)}")
        if free | held != set(range(self.num_pages)):
            raise AssertionError("pages leaked: neither free nor "
                                 "referenced")
        if any(r < 1 for r in self._refs.values()):
            raise AssertionError("non-positive refcount retained")

    # -- allocation ------------------------------------------------------
    def alloc(self, n: int) -> Optional[List[int]]:
        """Allocate ``n`` pages at refcount 1, or None (pool unchanged)
        when fewer than ``n`` are free."""
        if n < 0:
            raise ValueError("negative allocation")
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        for p in out:
            self._refs[p] = 1
        return out

    def incref(self, pages) -> None:
        for p in pages:
            if p not in self._refs:
                raise AssertionError(f"incref on unallocated page {p}")
            self._refs[p] += 1

    def decref(self, pages) -> int:
        """Drop one reference per page; pages reaching zero return to
        the free list. Returns how many pages were actually freed."""
        freed = 0
        for p in pages:
            r = self._refs.get(p)
            if r is None:
                raise AssertionError(f"decref on unallocated page {p}")
            if r == 1:
                del self._refs[p]
                self._free.append(p)
                freed += 1
            else:
                self._refs[p] = r - 1
        return freed


class _TrieNode:
    __slots__ = ("page", "children", "parent", "key", "last_used")

    def __init__(self, page: Optional[int], parent=None, key=None):
        self.page = page
        self.children: Dict[Tuple[int, ...], _TrieNode] = {}
        self.parent = parent
        self.key = key
        self.last_used = 0


class PrefixTrie:
    """Prefix cache over complete pages (see module docstring).

    The trie owns ONE allocator reference per node — ``insert`` increfs,
    ``evict`` decrefs. Pages a live slot still references (refcount > 1)
    are never evicted; eviction order is LRU over current leaves, and
    evicting a leaf exposes its parent, so an unreferenced chain drains
    fully when the pool is under pressure.
    """

    def __init__(self, allocator: PageAllocator):
        self.alloc = allocator
        self.root = _TrieNode(None)
        self._clock = 0
        self.pages_cached = 0

    def _touch(self, node: _TrieNode) -> None:
        self._clock += 1
        node.last_used = self._clock

    def match(self, page_keys: List[Tuple[int, ...]]) -> List[int]:
        """Longest cached chain of ``page_keys`` (each the exact token
        tuple of one complete page); returns the physical pages of the
        matched prefix, LRU-touched."""
        node, out = self.root, []
        for key in page_keys:
            child = node.children.get(key)
            if child is None:
                break
            self._touch(child)
            out.append(child.page)
            node = child
        return out

    def insert(self, page_keys: List[Tuple[int, ...]],
               pages: List[int]) -> int:
        """Register a chain of complete pages. Keys already cached are
        left untouched (first writer wins — the content is identical by
        construction); each NEW node takes one allocator reference on
        its physical page. Returns how many new pages were cached."""
        node, added = self.root, 0
        for key, page in zip(page_keys, pages):
            child = node.children.get(key)
            if child is None:
                child = _TrieNode(page, parent=node, key=key)
                node.children[key] = child
                self.alloc.incref([page])
                self.pages_cached += 1
                added += 1
            self._touch(child)
            node = child
        return added

    def _leaves(self):
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root and not node.children:
                yield node
            stack.extend(node.children.values())

    def evict(self, n_pages: int) -> int:
        """Free up to ``n_pages`` pages by dropping least-recently-used
        leaves whose pages only the trie still references. Returns the
        number of pages actually freed to the pool."""
        freed = 0
        while freed < n_pages:
            victims = [nd for nd in self._leaves()
                       if self.alloc.refcount(nd.page) == 1]
            if not victims:
                break
            victim = min(victims, key=lambda nd: nd.last_used)
            del victim.parent.children[victim.key]
            freed += self.alloc.decref([victim.page])
            self.pages_cached -= 1
        return freed

    def fingerprints(self, limit: int = 512) -> List[int]:
        """Chained crc32 ids of the cached prefix chains (one per
        node, bounded): node fingerprint = crc32(page key, parent
        fingerprint) — the cross-process identity a replica exports
        via /healthz for the router's prefix-affinity scoring (a
        prompt whose :func:`chain_hashes` prefix lands in this set has
        that many pages of KV already cached here)."""
        out: List[int] = []
        stack = [(self.root, 0)]
        while stack and len(out) < limit:
            node, h = stack.pop()
            for key, child in list(node.children.items()):
                ch = zlib.crc32(repr(key).encode(), h)
                out.append(ch)
                if len(out) >= limit:
                    break
                stack.append((child, ch))
        return out

    def reclaimable(self) -> int:
        """How many cached pages eviction could actually free right now
        (trie-only references — pages live slots also hold are pinned).
        The engine's truthful cache_exhausted shed reads this."""
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            if node is not self.root \
                    and self.alloc.refcount(node.page) == 1:
                count += 1
            stack.extend(node.children.values())
        return count

    def evict_all(self) -> int:
        """Drop every droppable node (diagnostics/tests)."""
        return self.evict(self.pages_cached)
