"""Host-side paged-KV block manager: the port of hip_llama_tpu/engine/
block_manager.py, with the same semantics (pure Python; no tensor touches
it).

A free-list allocator over a fixed pool of physical pages, one page table
per slot, shared by all layers. The device side (page-indexed attention and
page-granular KV writes) lives in models/paged.py and the ops/ kernels.

Automatic prefix caching: a page whose positions are fully covered by a
request's prompt holds KV that depends only on the token prefix up to its
end, so identical prompt prefixes can SHARE physical pages (causal
attention; prefill chunking is page-aligned from 0, so the bytes are
identical too). Pages are registered in a chain-keyed index (key_i =
(key_{i-1}, tokens of page i)), matched at admission, refcounted across
slots, retained after their last owner retires, and evicted LRU when the
allocator runs dry. Shared pages are never written again: prefill writes
rows [0, len(prompt)-1) and decode writes rows >= len(prompt)-1, and only
pages with end <= len(prompt)-1 are registered.
"""

from __future__ import annotations

import dataclasses


class OutOfPagesError(RuntimeError):
    pass


@dataclasses.dataclass
class BlockManager:
    """Maps (slot, logical page) -> physical page over a fixed pool."""

    num_pages: int
    page_size: int
    num_slots: int

    #: Physical page 0 is RESERVED as the trash page and never allocated.
    #: Idle slots (retired, table cleared) still run the fixed-shape decode
    #: step, and their KV row writes land at the table's padding target —
    #: page 0. If page 0 were allocatable, an idle slot would clobber a live
    #: request's first page. The pool therefore holds num_pages + 1 physical
    #: pages (engine.new_cache).
    TRASH_PAGE = 0

    def __post_init__(self):
        # usable physical ids are 1..num_pages; pop() hands out 1 first
        self._free: list[int] = list(range(self.num_pages, 0, -1))
        # page_tables[slot] = list of physical page ids, logical order
        self.page_tables: list[list[int]] = [[] for _ in range(self.num_slots)]
        # prefix cache state (all empty unless register_prefix is used):
        self._refcount: dict[int, int] = {}  # physical page -> live owners
        self._index: dict[tuple, int] = {}  # chain key -> physical page
        self._page_key: dict[int, tuple] = {}  # physical page -> chain key
        # retained pages (registered, refcount 0), insertion order = LRU
        self._lru: dict[int, None] = {}
        self.prefix_hit_tokens = 0  # stats: prompt tokens served from cache

    @property
    def num_free(self) -> int:
        """Pages available to allocate (free list + evictable retained)."""
        return len(self._free) + len(self._lru)

    def _alloc(self) -> int:
        if self._free:
            return self._free.pop()
        if self._lru:  # evict the oldest retained prefix page
            page = next(iter(self._lru))
            del self._lru[page]
            del self._index[self._page_key.pop(page)]
            return page
        raise OutOfPagesError(
            f"KV page pool exhausted ({self.num_pages} pages of {self.page_size})"
        )

    def ensure_capacity(self, slot: int, n_tokens: int) -> list[int]:
        """Ensure the slot's table covers positions [0, n_tokens); returns
        newly allocated physical pages."""
        table = self.page_tables[slot]
        need = -(-n_tokens // self.page_size)  # ceil
        new = []
        while len(table) < need:
            p = self._alloc()
            table.append(p)
            self._refcount[p] = 1
            new.append(p)
        return new

    def append_token(self, slot: int, pos: int) -> int | None:
        """Account one token at `pos`; allocates (and returns) a fresh page
        when `pos` opens one."""
        new = self.ensure_capacity(slot, pos + 1)
        return new[0] if new else None

    def free_slot(self, slot: int) -> None:
        for p in self.page_tables[slot]:
            n = self._refcount.get(p, 1) - 1
            if n > 0:
                self._refcount[p] = n
                continue
            self._refcount.pop(p, None)
            if p in self._page_key:  # registered: retain for future hits
                self._lru[p] = None
            else:
                self._free.append(p)
        self.page_tables[slot] = []

    # -- prefix caching ------------------------------------------------------

    def _chain_keys(self, tokens: list[int], limit: int):
        """Chain keys of the pages fully covered by prompt rows [0, limit);
        yields (page_index, key)."""
        ps = self.page_size
        key: tuple = ()
        for i in range(limit // ps):
            key = (key, tuple(tokens[i * ps:(i + 1) * ps]))
            yield i, key

    def match_prefix(self, slot: int, tokens: list[int]) -> int:
        """Attach the longest indexed chain of prompt-prefix pages to the
        (empty) slot and return the number of cached TOKENS. Only rows
        [0, len(tokens)-1) are eligible (prefill leaves the last prompt token
        to the first decode step, and its row lands in an unshared page).
        The caller accounts prefix_hit_tokens AFTER admission succeeds — a
        request that matches, fails admission, and retries must not count
        its hits once per retry."""
        table = self.page_tables[slot]
        assert not table, "match_prefix requires an empty slot"
        n = 0
        for i, key in self._chain_keys(tokens, len(tokens) - 1):
            page = self._index.get(key)
            if page is None:
                break
            table.append(page)
            self._refcount[page] = self._refcount.get(page, 0) + 1
            self._lru.pop(page, None)  # in use again
            n = (i + 1) * self.page_size
        return n

    def register_prefix(self, slot: int, tokens: list[int]) -> None:
        """Index the slot's pages that are fully covered by prompt rows
        [0, len(tokens)-1) so later identical prefixes can share them."""
        table = self.page_tables[slot]
        for i, key in self._chain_keys(tokens, len(tokens) - 1):
            page = table[i]
            if self._index.setdefault(key, page) == page:
                self._page_key[page] = key

    def table_array(self, slot: int, max_pages: int) -> list[int]:
        """Fixed-width table row. Unused entries point at the reserved trash
        page: attention never reads them (positions >= pos are masked), and
        idle-slot KV writes land there harmlessly."""
        t = self.page_tables[slot]
        return t + [self.TRASH_PAGE] * (max_pages - len(t))
