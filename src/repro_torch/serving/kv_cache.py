"""Host-side paged KV-cache bookkeeping (free list + block tables).

Page 0 is reserved as the trash page: inactive batch slots scatter their
(masked) writes there so the jitted step functions never branch on
activity. The device-side pools live in the runner's state pytree.
"""
from __future__ import annotations

from typing import List, Optional

import numpy as np


class PageManager:
    def __init__(self, num_pages: int, page_size: int, max_batch: int,
                 max_pages_per_seq: int):
        assert num_pages >= 2
        self.num_pages = num_pages
        self.page_size = page_size
        self.max_batch = max_batch
        self.max_pages_per_seq = max_pages_per_seq
        # page 0 reserved (trash)
        self.free: List[int] = list(range(num_pages - 1, 0, -1))
        self.block_tables = np.zeros((max_batch, max_pages_per_seq),
                                     np.int32)
        self.pages_of: List[List[int]] = [[] for _ in range(max_batch)]
        self.free_slots: List[int] = list(range(max_batch - 1, -1, -1))

    # -- capacity queries ---------------------------------------------------
    def pages_for(self, tokens: int) -> int:
        return -(-tokens // self.page_size)

    def can_admit(self, prompt_len: int, max_new: int) -> bool:
        need = self.pages_for(prompt_len + max_new)
        if need > self.max_pages_per_seq:
            return False                    # request can never fit
        return bool(self.free_slots) and len(self.free) >= need

    @property
    def free_pages(self) -> int:
        return len(self.free)

    # -- allocation ---------------------------------------------------------
    def admit(self, prompt_len: int, max_new: int) -> Optional[int]:
        """Reserve a slot + pages for the whole request. None if full."""
        if not self.can_admit(prompt_len, max_new):
            return None
        slot = self.free_slots.pop()
        need = self.pages_for(prompt_len + max_new)
        assert need <= self.max_pages_per_seq, (
            f"request needs {need} pages > max_pages_per_seq "
            f"{self.max_pages_per_seq}")
        # take the last `need` pages in pop() order (one slice, not n pops);
        # guard need==0: `del free[-0:]` would wipe the whole free list
        pages = self.free[:-need - 1:-1] if need else []
        if need:
            del self.free[-need:]
        self.pages_of[slot] = pages
        self.block_tables[slot, :need] = pages
        self.block_tables[slot, need:] = 0
        return slot

    def release(self, slot: int):
        self.free.extend(self.pages_of[slot])
        self.pages_of[slot] = []
        self.block_tables[slot] = 0
        self.free_slots.append(slot)

    def utilization(self) -> float:
        usable = self.num_pages - 1
        return 1.0 - len(self.free) / usable
