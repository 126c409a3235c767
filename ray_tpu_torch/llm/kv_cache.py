"""Paged KV cache: fixed-size pages + per-sequence page tables.

Port of ``ray_tpu/llm/kv_cache.py``.  The page accounting, refcounts and
prefix trie are the same code; storage is one f32 torch tensor per layer for
K and for V, shaped ``[num_pages, page_size, num_heads, head_dim]`` on the
cache's device (the CUDA card unless ``"cpu"`` is passed), written and read
with tensor indexing.  A sequence owns an ordered list of page ids, and token
position ``p`` of that sequence lives at ``(pages[p // page_size],
p % page_size)`` in EVERY layer — one page id indexes all layers, so
alloc/free accounting is per sequence, not per layer.

Prefix caching (``enable_prefix_cache=True``): committed FULL pages of
prompt tokens are indexed by a radix trie keyed on page-sized token chunks
(reference: SGLang's RadixAttention / vLLM's prefix caching).  Pages carry
refcounts — one per sequence page table holding the page plus one if a trie
node holds it — and the free list only ever contains refcount-0 pages.  A
new request forks from the longest trie match: shared full pages are
adopted read-only (incref), a partial boundary page is copy-on-write forked
into a private page, and prefill starts at the match point.  Cached pages
whose only holder is the trie are reclaimed LRU (leaf-first) when a
reservation would otherwise exhaust the pool, so the trie is a best-effort
cache, never a source of CacheExhausted.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

from ray_tpu_torch._private.device import resolve_device


class CacheExhausted(RuntimeError):
    """No free pages for the requested reservation (caller may preempt)."""


@dataclass(frozen=True)
class CacheConfig:
    num_layers: int
    num_heads: int
    head_dim: int
    num_pages: int = 64
    page_size: int = 16
    enable_prefix_cache: bool = False

    def __post_init__(self):
        if self.num_pages <= 0 or self.page_size <= 0:
            raise ValueError("num_pages and page_size must be > 0")
        if self.num_layers <= 0 or self.num_heads <= 0 or self.head_dim <= 0:
            raise ValueError("layers/heads/head_dim must be > 0")


class _SeqEntry:
    __slots__ = ("pages", "length")

    def __init__(self):
        self.pages: List[int] = []
        self.length = 0  # committed tokens


class _TrieNode:
    """One full page of cached prefix: ``key`` is the page_size-token chunk
    that extends the parent's path, ``page`` the page id holding its K/V."""

    __slots__ = ("key", "page", "children", "parent", "tick")

    def __init__(self, key: Optional[Tuple[int, ...]], page: int,
                 parent: Optional["_TrieNode"]):
        self.key = key
        self.page = page
        self.children: Dict[Tuple[int, ...], "_TrieNode"] = {}
        self.parent = parent
        self.tick = 0  # monotonic last-use counter (LRU eviction order)


class PagedKVCache:
    """Not thread-safe: the engine serializes all cache access under its
    lock (scheduler planning) or confines it to the step thread (runner
    reads/writes)."""

    def __init__(self, config: CacheConfig, device=None):
        self.config = config
        self.device = resolve_device(device)
        shape = (config.num_pages, config.page_size,
                 config.num_heads, config.head_dim)
        self._k = [torch.zeros(shape, dtype=torch.float32, device=self.device)
                   for _ in range(config.num_layers)]
        self._v = [torch.zeros(shape, dtype=torch.float32, device=self.device)
                   for _ in range(config.num_layers)]
        # LIFO free list: recently-freed pages are re-used first (warm)
        self._free: List[int] = list(range(config.num_pages - 1, -1, -1))
        self._seqs: Dict[str, _SeqEntry] = {}
        self.peak_pages_used = 0
        # prefix cache state: per-page refcount (#sequence page tables
        # holding the page + 1 if a trie node holds it; free <=> 0), the
        # radix trie root, and page id -> trie node for eviction walks.
        self._ref: List[int] = [0] * config.num_pages
        self._root = _TrieNode(None, -1, None)
        self._trie_pages: Dict[int, _TrieNode] = {}
        self._tick = 0
        self.prefix_hits = 0        # fork_from_prefix calls that matched
        self.prefix_hit_tokens = 0  # tokens adopted from the trie

    # ------------------------------------------------------- accounting
    @property
    def num_pages(self) -> int:
        return self.config.num_pages

    @property
    def page_size(self) -> int:
        return self.config.page_size

    @property
    def free_pages(self) -> int:
        return len(self._free)

    @property
    def used_pages(self) -> int:
        return self.config.num_pages - len(self._free)

    def utilization(self) -> float:
        return self.used_pages / self.config.num_pages

    def pages_for(self, num_tokens: int) -> int:
        return -(-num_tokens // self.config.page_size)  # ceil div

    def has_seq(self, seq_id: str) -> bool:
        return seq_id in self._seqs

    def seq_len(self, seq_id: str) -> int:
        return self._seqs[seq_id].length

    def pages_of(self, seq_id: str) -> List[int]:
        return list(self._seqs[seq_id].pages)

    @property
    def trie_pages(self) -> int:
        """Pages currently held by the prefix-cache trie."""
        return len(self._trie_pages)

    def check_leaks(self) -> None:
        """Invariants: (1) without sharing, every page is free XOR owned by
        exactly one sequence; (2) with prefix caching, every page's refcount
        equals the number of sequence page tables holding it plus one if a
        trie node holds it, and the free list is exactly the refcount-0
        pages (the leak-accounting tests assert this after churn)."""
        expect = [0] * self.config.num_pages
        for e in self._seqs.values():
            if len(e.pages) != len(set(e.pages)):
                raise AssertionError("duplicate page in a sequence table")
            for p in e.pages:
                expect[p] += 1
        for p in self._trie_pages:
            expect[p] += 1
        if not self.config.enable_prefix_cache:
            if any(c > 1 for c in expect):
                raise AssertionError("page owned by more than one sequence")
        for p, (want, have) in enumerate(zip(expect, self._ref)):
            if want != have:
                raise AssertionError(
                    f"refcount imbalance on page {p}: recorded {have}, "
                    f"{want} holders (seq tables + trie nodes)")
        free = set(self._free)
        if len(free) != len(self._free):
            raise AssertionError("duplicate page in free list")
        zero = {p for p, c in enumerate(expect) if c == 0}
        if free != zero:
            raise AssertionError(
                f"free list {sorted(free)} != refcount-0 pages "
                f"{sorted(zero)}")
        # trie structure: node map consistent with the tree
        for p, node in self._trie_pages.items():
            if node.page != p:
                raise AssertionError("trie page map points at wrong node")
            if node.parent is None \
                    or node.parent.children.get(node.key) is not node:
                raise AssertionError("trie node detached from its parent")

    # ------------------------------------------------------- allocation
    def can_reserve(self, seq_id: str, new_len: int) -> bool:
        have = len(self._seqs[seq_id].pages) if seq_id in self._seqs else 0
        avail = len(self._free) + self._evictable_pages()
        return self.pages_for(new_len) - have <= avail

    def reserve(self, seq_id: str, new_len: int) -> None:
        """Grow ``seq_id``'s page table to cover ``new_len`` tokens.
        All-or-nothing: raises CacheExhausted without allocating anything
        when the free pool (plus evictable trie pages) can't cover the
        growth."""
        entry = self._seqs.get(seq_id)
        if entry is None:
            entry = self._seqs.setdefault(seq_id, _SeqEntry())
        need = self.pages_for(new_len) - len(entry.pages)
        if need <= 0:
            return
        if need > len(self._free):
            self._evict_trie(need - len(self._free))
        if need > len(self._free):
            if not entry.pages and entry.length == 0:
                # never-written fresh entry: don't leave an empty table
                self._seqs.pop(seq_id, None)
            raise CacheExhausted(
                f"need {need} pages for seq {seq_id!r} "
                f"(len {new_len}), {len(self._free)} free")
        for _ in range(need):
            page = self._free.pop()
            self._ref[page] = 1
            entry.pages.append(page)
        self.peak_pages_used = max(self.peak_pages_used, self.used_pages)

    def free(self, seq_id: str) -> int:
        """Release every page of ``seq_id`` (completion, abort, preemption
        with recompute-on-resume).  Shared pages (prefix cache) just drop
        one reference; pages the trie still holds stay cached.  Returns the
        number of pages actually returned to the free pool."""
        entry = self._seqs.pop(seq_id, None)
        if entry is None:
            return 0
        released = 0
        for page in reversed(entry.pages):
            self._ref[page] -= 1
            if self._ref[page] == 0:
                self._free.append(page)
                released += 1
        return released

    # ---------------------------------------------------- prefix caching
    def _touch(self, node: _TrieNode) -> None:
        self._tick += 1
        node.tick = self._tick

    def match_prefix(self, tokens: Sequence[int]) -> List[_TrieNode]:
        """Longest trie walk over full page_size-token chunks of ``tokens``.
        Returns the matched node chain root-outward (may be empty)."""
        ps = self.config.page_size
        chain: List[_TrieNode] = []
        cur = self._root
        for i in range(len(tokens) // ps):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            nxt = cur.children.get(key)
            if nxt is None:
                break
            self._touch(nxt)
            chain.append(nxt)
            cur = nxt
        return chain

    def fork_from_prefix(self, seq_id: str, tokens: Sequence[int]) -> int:
        """Create ``seq_id``'s page table by adopting the longest cached
        prefix of ``tokens``: shared full pages are taken read-only
        (incref); when the usable prefix ends mid-page (a prefill must
        still compute >= 1 token, so the match is capped at
        ``len(tokens) - 1``) the boundary page is copy-on-write forked into
        a private page.  Returns the number of committed tokens adopted
        (0 = no match; the entry is then not created)."""
        if not self.config.enable_prefix_cache:
            return 0
        if seq_id in self._seqs:
            raise ValueError(f"seq {seq_id!r} already exists")
        ps = self.config.page_size
        chain = self.match_prefix(tokens)
        if not chain:
            return 0
        # cap: leave at least the final token to compute for logits
        matched = min(len(chain) * ps, len(tokens) - 1)
        n_pages = self.pages_for(matched)
        if n_pages <= 0:
            return 0
        entry = _SeqEntry()
        for node in chain[:n_pages]:
            self._ref[node.page] += 1
            entry.pages.append(node.page)
        entry.length = matched
        self._seqs[seq_id] = entry
        if matched % ps:
            # boundary page is shared but the tail of it will be written:
            # fork it now (or drop the partial page if no page is free)
            src = entry.pages[-1]
            if not self._free:
                self._evict_trie(1)
            if self._free:
                dst = self._free.pop()
                self._ref[dst] = 1
                self._copy_page(src, dst)
                entry.pages[-1] = dst
                self._ref[src] -= 1
            else:
                entry.pages.pop()
                self._ref[src] -= 1
                matched = (matched // ps) * ps
                entry.length = matched
                if matched == 0:
                    self._seqs.pop(seq_id)
                    return 0
        self.peak_pages_used = max(self.peak_pages_used, self.used_pages)
        self.prefix_hits += 1
        self.prefix_hit_tokens += matched
        return matched

    def insert_prefix(self, seq_id: str, tokens: Sequence[int]) -> int:
        """Index ``seq_id``'s committed full pages covering ``tokens``
        (typically the prompt, or the committed part of it) into the trie
        so later requests can adopt them.  Pages already present under the
        same token path are left as-is.  Returns newly inserted pages."""
        if not self.config.enable_prefix_cache:
            return 0
        entry = self._seqs.get(seq_id)
        if entry is None:
            return 0
        ps = self.config.page_size
        n_full = min(len(tokens), entry.length) // ps
        cur = self._root
        added = 0
        for i in range(n_full):
            key = tuple(tokens[i * ps:(i + 1) * ps])
            nxt = cur.children.get(key)
            if nxt is None:
                page = entry.pages[i]
                if page in self._trie_pages:
                    # same physical page can't sit under two paths; the
                    # caller's tokens diverged from what the page holds
                    raise AssertionError(
                        f"page {page} already indexed under another path")
                nxt = _TrieNode(key, page, cur)
                cur.children[key] = nxt
                self._trie_pages[page] = nxt
                self._ref[page] += 1
                added += 1
            self._touch(nxt)
            cur = nxt
        return added

    def _evictable_pages(self) -> int:
        """Pages reclaimable by leaf-first trie eviction: nodes whose page
        only the trie holds AND whose whole subtree is likewise only
        trie-held (evicting an interior node would orphan its children)."""
        def walk(node: _TrieNode) -> Tuple[int, bool]:
            count, all_ev = 0, True
            for child in node.children.values():
                c, ev = walk(child)
                count += c
                all_ev = all_ev and ev
            if node is self._root:
                return count, all_ev
            if all_ev and self._ref[node.page] == 1:
                return count + 1, True
            return count, False

        return walk(self._root)[0]

    def _evict_trie(self, need: int) -> int:
        """Evict up to ``need`` pages from the trie, LRU over childless
        nodes whose page the trie alone holds (refcount 1).  Shared pages
        are never evicted — eviction frees cache, never corrupts a
        sequence."""
        freed = 0
        while freed < need:
            victim = None
            for page, node in self._trie_pages.items():
                if node.children or self._ref[page] != 1:
                    continue
                if victim is None or node.tick < victim.tick:
                    victim = node
            if victim is None:
                break
            victim.parent.children.pop(victim.key)
            self._trie_pages.pop(victim.page)
            self._ref[victim.page] = 0
            self._free.append(victim.page)
            freed += 1
        return freed

    def _copy_page(self, src: int, dst: int) -> None:
        """Copy one page's K/V across every layer (CoW boundary fork)."""
        for layer in range(self.config.num_layers):
            self._k[layer][dst] = self._k[layer][src]
            self._v[layer][dst] = self._v[layer][src]

    # ------------------------------------------------------------- data
    def _slots(self, entry: _SeqEntry, start: int, n: int) -> torch.Tensor:
        """Flat ``page * page_size + offset`` slots of positions
        start..start+n-1, as an index tensor on the cache's device."""
        ps = self.config.page_size
        first = start // ps
        pages = torch.tensor(entry.pages[first:self.pages_for(start + n)],
                             dtype=torch.long, device=self.device)
        slots = (pages[:, None] * ps
                 + torch.arange(ps, device=self.device)).flatten()
        return slots[start - first * ps:start - first * ps + n]

    def write(self, seq_id: str, layer: int, start: int, k, v) -> None:
        """Scatter ``k``/``v`` of shape [T, heads, head_dim] (tensors or
        arrays) into the pages of ``seq_id`` at token positions
        start..start+T-1 (pages must be reserved first)."""
        entry = self._seqs[seq_id]
        k = torch.as_tensor(k, dtype=torch.float32, device=self.device)
        v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
        T = k.shape[0]
        ps = self.config.page_size
        if self.pages_for(start + T) > len(entry.pages):
            raise IndexError(
                f"write past reservation for seq {seq_id!r}: "
                f"pos {start + T} > {len(entry.pages)} pages")
        for idx in range(start // ps, self.pages_for(start + T)):
            page = entry.pages[idx]
            if self._ref[page] != 1:
                # CoW discipline: shared pages (other sequences or the
                # trie hold them too) are read-only; writers must have
                # forked first
                raise AssertionError(
                    f"write to shared page {page} (refcount "
                    f"{self._ref[page]}) by seq {seq_id!r}")
        slots = self._slots(entry, start, T)
        H, D = self.config.num_heads, self.config.head_dim
        self._k[layer].view(-1, H, D)[slots] = k
        self._v[layer].view(-1, H, D)[slots] = v

    def commit(self, seq_id: str, new_len: int) -> None:
        """Mark tokens up to ``new_len`` as valid (call after writing all
        layers, so a mid-write failure never exposes torn state)."""
        entry = self._seqs[seq_id]
        if self.pages_for(new_len) > len(entry.pages):
            raise IndexError("commit past reservation")
        entry.length = max(entry.length, new_len)

    def gather(self, seq_id: str, layer: int,
               length: Optional[int] = None) -> torch.Tensor:
        """Contiguous [length, heads, head_dim] K of ``seq_id``'s cache
        (use ``gather_kv`` for both), on the cache's device."""
        return self.gather_kv(seq_id, layer, length)[0]

    def gather_kv(self, seq_id: str, layer: int,
                  length: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
        entry = self._seqs[seq_id]
        n = entry.length if length is None else length
        if n > entry.length:
            raise IndexError(f"gather {n} > committed {entry.length}")
        slots = self._slots(entry, 0, n)
        H, D = self.config.num_heads, self.config.head_dim
        return (self._k[layer].view(-1, H, D)[slots],
                self._v[layer].view(-1, H, D)[slots])
