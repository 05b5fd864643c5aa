"""KV slot manager: one static-shape cache, per-row request lifecycles.

The counterpart of llama_pipeline_parallel_tpu/serve/slots.py. The cache is
allocated ONCE at `[n_layers, max_slots, max_len, kv_heads, head_dim]` on
the engine's device and its batch axis is read as SLOTS:

- `acquire()` hands out a free row (lowest index first).
- `admit(slot, prefill_out)` copies a `decode.prefill_prompt` result into
  the row and rewrites the row's kv mask, in place: whatever the previous
  occupant left behind is overwritten or masked to exact zeros in softmax.
- `release(slot)` returns the row to the free list; no device work. The
  freed row keeps riding the decode step as garbage until reuse; its
  sampled tokens are discarded by the scheduler.

`assignments` keeps a (slot, request_id) history and `allocations` counts
cache allocations (it stays 1 for the life of the engine). Every slot is
charged `max_len`; the paged cache (serve/pages.py) backs the same rows
with pages so memory tracks tokens written.
"""

from __future__ import annotations

import torch

from llama_pipeline_parallel_tpu_torch.models.llama import decode
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig


class SlotKVCache:
    def __init__(self, cfg: LlamaConfig, max_slots: int, max_len: int, *,
                 device: str | torch.device = "cuda"):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if max_len < 2:
            raise ValueError(f"max_len must be >= 2 (one prompt token + one "
                             f"generated), got {max_len}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.cache = decode.init_kv_cache(cfg, max_slots, max_len, device=device)
        self.kv_mask = torch.zeros((max_slots, max_len), dtype=torch.int32, device=device)
        self._free = list(range(max_slots - 1, -1, -1))  # pop() -> lowest
        self.assignments: list[tuple[int, str]] = []
        self.allocations = 1

    # -- lifecycle ---------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free)

    @property
    def active_count(self) -> int:
        return self.max_slots - len(self._free)

    def acquire(self, request_id: str, reserved_pages: int = 0) -> int | None:
        """A free slot index, or None when every row is occupied.
        `reserved_pages` is accepted (and ignored) so the engine's one
        admission path treats both caches alike: the dense row IS the
        reservation."""
        if not self._free:
            return None
        slot = self._free.pop()
        self.assignments.append((slot, request_id))
        return slot

    def release(self, slot: int) -> None:
        if slot in self._free or not 0 <= slot < self.max_slots:
            raise ValueError(f"release of slot {slot} not currently held")
        self._free.append(slot)
        self._free.sort(reverse=True)  # keep lowest-first hand-out

    def admit(self, slot: int, prefill_out: dict) -> None:
        """Write a `prefill_prompt` result (b == 1) into row `slot`."""
        decode.write_slot(self.cache, self.kv_mask, slot, prefill_out["cache"],
                          prefill_out["kv_mask"])

    # -- decode-step plumbing ---------------------------------------------

    def update_from_step(self, step_out: dict) -> None:
        """Adopt the cache / kv_mask a `decode.decode_step` returned (the
        same tensors, updated in place)."""
        self.cache = step_out["cache"]
        self.kv_mask = step_out["kv_mask"]

    def reused_slot_count(self) -> int:
        """How many slots have served more than one request so far."""
        seen: dict[int, int] = {}
        for slot, _ in self.assignments:
            seen[slot] = seen.get(slot, 0) + 1
        return sum(1 for n in seen.values() if n > 1)
