"""Paged KV-cache accounting (vLLM-style block tables, paper §3.1).

On TPU the device-side decode cache is slot-dense (JetStream-style) — HBM
has no fragmentation problem to page over — so the *pool accounting* is the
part of PagedAttention that transfers (DESIGN.md §2): pages gate admission,
drive eviction, and export the "KV-cache occupancy" signal of Table 2(b).
The Pallas ``paged_attention`` kernel consumes the same block tables when a
physically paged pool is wanted (see kernels/).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class PageStats:
    total_pages: int
    free_pages: int
    seqs: int
    allocated: int = 0
    failed: int = 0
    evictions: int = 0

    @property
    def occupancy(self) -> float:
        return 1.0 - self.free_pages / max(self.total_pages, 1)


class PagedKVPool:
    """Page allocator with per-sequence block tables."""

    def __init__(self, n_pages: int, page_size: int) -> None:
        self.page_size = page_size
        self.n_pages = n_pages
        self._free: list[int] = list(range(n_pages))
        self._tables: dict[int, list[int]] = {}
        self._len: dict[int, int] = {}
        self.stats = PageStats(total_pages=n_pages, free_pages=n_pages,
                               seqs=0)

    def pages_needed(self, n_tokens: int) -> int:
        return -(-n_tokens // self.page_size)

    def can_admit(self, n_tokens: int) -> bool:
        return self.pages_needed(n_tokens) <= len(self._free)

    def allocate(self, seq_id: int, n_tokens: int) -> list[int] | None:
        need = self.pages_needed(n_tokens)
        if need > len(self._free):
            self.stats.failed += 1
            return None
        pages = [self._free.pop() for _ in range(need)]
        self._tables[seq_id] = pages
        self._len[seq_id] = n_tokens
        self.stats.seqs += 1
        self.stats.allocated += need
        self.stats.free_pages = len(self._free)
        return pages

    def extend(self, seq_id: int, n_tokens: int = 1) -> bool:
        """Grow a sequence; allocates a new page on boundary crossing."""
        cur = self._len[seq_id]
        new = cur + n_tokens
        while self.pages_needed(new) > len(self._tables[seq_id]):
            if not self._free:
                self.stats.failed += 1
                return False
            self._tables[seq_id].append(self._free.pop())
            self.stats.allocated += 1
        self._len[seq_id] = new
        self.stats.free_pages = len(self._free)
        return True

    def free(self, seq_id: int) -> None:
        pages = self._tables.pop(seq_id, [])
        self._len.pop(seq_id, None)
        self._free.extend(pages)
        self.stats.seqs -= 1
        self.stats.free_pages = len(self._free)

    def evict_lru(self) -> int | None:
        """Evict the shortest sequence (stand-in policy) to relieve
        pressure — the paper's 'early KV-cache eviction' mitigation."""
        if not self._tables:
            return None
        victim = min(self._len, key=self._len.__getitem__)
        self.free(victim)
        self.stats.evictions += 1
        return victim

    def table(self, seq_id: int) -> list[int]:
        return self._tables[seq_id]

    def occupancy(self) -> float:
        return self.stats.occupancy
