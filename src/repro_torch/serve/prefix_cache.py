"""Cross-request KV prefix cache — VBI page sharing for the serve path
(counterpart of ``repro/serve/prefix_cache.py``; pure Python, copied and
edited here, never imported).

The thesis' VBI chapter argues that a memory interface which understands
data properties can share and clone physical blocks cheaply (``MTL.clone_vb``
copy-on-write).  This module applies that claim to the serve engine's
dominant workload: many requests sharing a system prompt.  It is a
host-side radix trie over *page-granular token blocks*; each node maps one
fully-written KV page (a device page id in ``PagedServeState``) and the trie
path spells the token prefix that produced it.  Admission walks the trie,
maps the longest cached prefix read-only into the new slot's page table (one
device scatter — no recompute, no data movement), COW-clones the last
partially-matching page, and prefills only the uncached suffix.

Custody protocol (keeps the VBIAllocator's host page mirror exact).  This
module is a pure host-side index: it never touches device pages itself —
every custody change goes through the one memory API
(``core/vbi/blocks.py::VBIAllocator``):

* every cached node holds exactly one device reference on its page
  (``VBIAllocator.retain``, custody moved out of the inserting block's
  reservation), taken when a slot's freshly prefilled prompt pages are
  inserted; the page then outlives the slot;
* every slot that maps a cached page (``VBIAllocator.map_shared``) pins the
  node (``pin``) for its lifetime, so eviction only ever touches pages
  whose device refcount is exactly 1 — freeing them
  (``VBIAllocator.release``) is unconditional and the mirror stays
  arithmetic, never synced;
* eviction is LRU over unpinned leaves (children evict before parents, so
  the trie always remains a valid prefix index).

The cache stores no KV data — only page *ids*.  The data never moves; only
translations do, which is the paper's point.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, List, Optional, Sequence, Tuple


class _Node:
    """One cached page: its token block, device page id, and LRU/pin state."""

    __slots__ = ("block", "page", "children", "parent", "refs", "last_used")

    def __init__(self, block: Tuple[int, ...], page: int,
                 parent: Optional["_Node"], clock: int):
        self.block = block
        self.page = page
        self.children: Dict[Tuple[int, ...], "_Node"] = {}
        self.parent = parent
        self.refs = 0            # active slots mapping / inserting this page
        self.last_used = clock


@dataclasses.dataclass
class PrefixMatch:
    """Result of a lookup: full shared pages + an optional COW source.

    ``pages[i]`` backs tokens ``[i*ps, (i+1)*ps)``; ``partial_page`` (if
    ≥ 0) additionally backs ``partial_len`` tokens past the full pages and
    must be COW-cloned before the slot writes its suffix into that page.
    """
    nodes: List[_Node]
    pages: List[int]
    n_tokens: int = 0            # total matched tokens (full pages + partial)
    partial_node: Optional[_Node] = None
    partial_page: int = -1
    partial_len: int = 0

    def all_nodes(self) -> List[_Node]:
        return self.nodes + ([self.partial_node] if self.partial_node else [])


class PrefixCache:
    """Radix trie from token-block tuples to refcounted device KV pages."""

    def __init__(self, page_size: int, min_partial: int = 1):
        if page_size <= 0:
            raise ValueError(f"page_size must be positive, got {page_size}")
        self.page_size = page_size
        self.min_partial = min_partial   # shortest partial match worth a COW
        self.root: Dict[Tuple[int, ...], _Node] = {}
        self._clock = 0
        self._n_pages = 0
        self._pinned = 0
        self.stats = {"lookups": 0, "hits": 0, "tokens_matched": 0,
                      "tokens_requested": 0, "inserted_pages": 0,
                      "evicted_pages": 0, "partial_matches": 0}

    # -- introspection -------------------------------------------------------
    @property
    def n_pages(self) -> int:
        """Device pages currently owned (refcounted) by the cache."""
        return self._n_pages

    @property
    def evictable_pages(self) -> int:
        return self._n_pages - self._pinned

    @property
    def hit_rate(self) -> float:
        return self.stats["hits"] / max(self.stats["lookups"], 1)

    def _iter_nodes(self) -> Iterator[_Node]:
        stack = list(self.root.values())
        while stack:
            n = stack.pop()
            yield n
            stack.extend(n.children.values())

    # -- lookup --------------------------------------------------------------
    def lookup(self, tokens: Sequence[int]) -> PrefixMatch:
        """Longest cached prefix of ``tokens``, capped at ``len(tokens)-1``
        so at least one prompt token is always prefilled (its logits seed
        the first generated token).  Read-only: stats and LRU recency move
        only when the match is actually used (:meth:`record`), so a
        budget-blocked request re-looked-up every scheduler tick neither
        inflates the hit rate nor makes its prefix artificially hot."""
        ps = self.page_size
        limit = len(tokens) - 1
        nodes: List[_Node] = []
        children = self.root
        pos = 0
        while pos + ps <= limit:
            child = children.get(tuple(tokens[pos:pos + ps]))
            if child is None:
                break
            nodes.append(child)
            children = child.children
            pos += ps
        # partial match of the next page: longest child block prefix that
        # agrees with the remaining tokens (the COW-clone candidate)
        rem = tuple(tokens[pos:limit])
        best, best_k = None, 0
        if rem:
            for blk, child in children.items():
                k = 0
                for a, b in zip(blk, rem):
                    if a != b:
                        break
                    k += 1
                if k > best_k:
                    best, best_k = child, k
        if best is None or best_k < self.min_partial:
            best, best_k = None, 0
        matched = len(nodes) * ps + best_k
        return PrefixMatch(
            nodes=nodes, pages=[n.page for n in nodes], n_tokens=matched,
            partial_node=best, partial_page=best.page if best else -1,
            partial_len=best_k)

    def record(self, match: PrefixMatch, n_tokens_requested: int) -> None:
        """Commit a lookup that led to an admission: count it in the stats
        and refresh the matched nodes' LRU recency."""
        self._clock += 1
        self.stats["lookups"] += 1
        self.stats["tokens_requested"] += n_tokens_requested
        if match.n_tokens:
            self.stats["hits"] += 1
            self.stats["tokens_matched"] += match.n_tokens
        if match.partial_node is not None:
            self.stats["partial_matches"] += 1
        for n in match.all_nodes():
            n.last_used = self._clock

    def drop_partial(self, match: PrefixMatch) -> None:
        """Forget a match's partial (COW) component — used when the source
        node itself is the page admission needs back."""
        match.n_tokens -= match.partial_len
        match.partial_node, match.partial_page, match.partial_len = \
            None, -1, 0

    # -- pinning (active-slot references; eviction never touches pinned) -----
    def pin(self, nodes: Sequence[_Node]) -> None:
        for n in nodes:
            if n.refs == 0:
                self._pinned += 1
            n.refs += 1

    def unpin(self, nodes: Sequence[_Node]) -> None:
        self._clock += 1
        for n in nodes:
            if n.refs <= 0:
                raise RuntimeError("unpin of unpinned node")
            n.refs -= 1
            if n.refs == 0:
                self._pinned -= 1
            n.last_used = self._clock

    # -- insertion -----------------------------------------------------------
    def insert(self, tokens: Sequence[int], page_ids: Sequence[int]
               ) -> List[_Node]:
        """Register fully-written prompt pages: ``page_ids[i]`` holds the KV
        of ``tokens[i*ps:(i+1)*ps]``.  Blocks already cached are skipped
        (first writer wins; the duplicate page stays with its slot).
        Returns the newly created nodes — the caller must move their pages
        to cache custody via ``VBIAllocator.retain(pages, from_block=…)``."""
        ps = self.page_size
        if len(tokens) < len(page_ids) * ps:
            raise ValueError(f"{len(page_ids)} pages of {ps} tokens need "
                             f"{len(page_ids) * ps} tokens, got "
                             f"{len(tokens)}")
        self._clock += 1
        new: List[_Node] = []
        children = self.root
        parent: Optional[_Node] = None
        for i, page in enumerate(page_ids):
            blk = tuple(tokens[i * ps:(i + 1) * ps])
            child = children.get(blk)
            if child is None:
                child = _Node(blk, int(page), parent, self._clock)
                children[blk] = child
                new.append(child)
                self._n_pages += 1
                self.stats["inserted_pages"] += 1
            child.last_used = self._clock
            parent = child
            children = child.children
        return new

    # -- LRU eviction --------------------------------------------------------
    def evict(self, want_pages: int) -> List[int]:
        """Drop up to ``want_pages`` cold pages (unpinned leaves, LRU first;
        removing a leaf may expose its parent).  Returns the device page ids
        to ``release_pages`` — each is guaranteed to have refcount exactly 1
        on device, so the host mirror can count them as freed."""
        out: List[int] = []
        while len(out) < want_pages:
            leaves = [n for n in self._iter_nodes()
                      if not n.children and n.refs == 0]
            if not leaves:
                break
            leaves.sort(key=lambda n: n.last_used)
            for victim in leaves:
                siblings = (victim.parent.children if victim.parent
                            else self.root)
                del siblings[victim.block]
                out.append(victim.page)
                self._n_pages -= 1
                self.stats["evicted_pages"] += 1
                if len(out) >= want_pages:
                    break
        return out
