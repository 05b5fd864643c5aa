"""Paged KV cache: fixed-size pages + a slot->page table (docs/SERVING.md).

The counterpart of llama_pipeline_parallel_tpu/serve/pages.py: the host-side
bookkeeping is the reference's line for line; the pool and the logical
kv mask live on the engine's device and are written in place.

`SlotKVCache` reserves `[max_slots, max_len]` up front — every slot is
charged one worst-case request whether it holds three tokens or three
thousand. This manager backs the same logical rows with PAGES from a shared
pool (`decode.init_page_pool`), so resident device memory tracks tokens actually
written:

- a request's **worst-case page demand** (`page_demand`) is reserved at
  submit time — admission control, the backpressure signal the frontend
  maps to HTTP 429 + Retry-After — but physical pages are allocated
  LAZILY: prompt pages at admission, decode pages as `write_pos` crosses
  each page boundary (`ensure_capacity`). Reservation <= pool is the
  invariant that makes mid-decode allocation infallible: a request that
  was admitted can always finish.
- `release` returns the slot's pages to the free pool, resets its
  page-table row to the GARBAGE page (index `num_pages` — the extra page
  every inactive slot scatters into while riding the static-shape decode
  step), and returns its reservation.
- the device state is the pool + the logical `[max_slots, max_len]`
  kv_mask; the page table itself stays HOST-side (numpy) and is shipped as
  a small int64 array each tick.

With `prefix_cache=True` (docs/SERVING.md "Prefix caching") physical pages
become SHAREABLE: every prompt is chain-hashed in page_size blocks of its
PADDED row (ids AND mask — a page's bytes depend on the whole padded
layout, so only element-identical rows share), a host-side prefix index
maps block-hash chains to physical pages, and `match_and_reserve` lets a
submit walk the longest cached chain, pin those pages, and reserve only the
NEW pages past the divergence point. The engine maps the pinned pages into
the slot's table row (a numpy edit — no kernel change, reads already
tolerate any mapping), recomputes only the tail, and registers the freshly
written prompt pages back into the index at prefill completion. Divergence
mid-page forks the containing page copy-on-write (`decode.copy_page`);
decode writes never touch shared pages (write_pos starts at the
page-aligned bucket, so the first decode write always claims a fresh
page). Every page holds a refcount while mapped/pinned; refcount-0 cached
pages sit on an LRU and are EVICTED (with their now-unreachable index
subtree) before an allocation would fail — the committed-pages invariant
`queued + slot_reserved + held_cached <= num_pages` keeps admitted
requests infallible exactly as before.

The interface mirrors `SlotKVCache` (acquire/admit/release/active_count/
assignments/allocations) so `ServeEngine` and tools/serve.py treat either
cache uniformly; the paged extras (reserve/ensure_capacity/page gauges)
only the paged scheduler touches, and every prefix-cache structure is
empty/byte-identical-in-behavior when `prefix_cache` is off.
"""

from __future__ import annotations

import dataclasses
import hashlib
import threading
from collections import OrderedDict

import numpy as np
import torch

from llama_pipeline_parallel_tpu_torch.models.llama import decode
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig


def page_demand(bucket: int, max_new_tokens: int, page_size: int) -> int:
    """Worst-case pages a request can ever touch: the prompt bucket plus
    the decode writes (the budget's last token is emitted without a cache
    write, so `max_new_tokens - 1` of them; a 1-token request writes only
    its prompt)."""
    positions = bucket + max(max_new_tokens - 1, 0)
    return -(-positions // page_size)


def dense_kv_cache_bytes(cfg: LlamaConfig, max_slots: int,
                         max_len: int) -> int:
    """Resident bytes of the dense `SlotKVCache` reservation."""
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return (2 * cfg.num_hidden_layers * max_slots * max_len * cfg.kv_heads
            * cfg.head_dim * itemsize)


def paged_pool_bytes(cfg: LlamaConfig, num_pages: int, page_size: int,
                     quant: str = "fp") -> int:
    """Resident bytes of a page pool (garbage page and int8 scales
    included — the capacity comparison must not hide overheads)."""
    itemsize = 1 if quant == "int8" else torch.empty((), dtype=cfg.dtype).element_size()
    kv = (2 * cfg.num_hidden_layers * (num_pages + 1) * page_size
          * cfg.kv_heads * cfg.head_dim * itemsize)
    if quant == "int8":
        kv += 2 * cfg.num_hidden_layers * (num_pages + 1) * cfg.kv_heads * 4
    return kv


def chain_hashes(ids_row: np.ndarray, mask_row: np.ndarray,
                 page_size: int) -> list:
    """One chain hash per page_size block of the PADDED row: h_i =
    H(h_{i-1} || ids_block || mask_block). KV at row position j is a pure
    function of row content [0, j] (pads are masked out of attention but
    written deterministically), so an equal chain hash means bit-equal page
    bytes for same-kernel writers — the sharing criterion. Hashing the mask
    alongside the ids is what makes pad-layout differences (same prompt,
    different bucket alignment) correctly NOT share."""
    n = len(ids_row) // page_size
    out = []
    h = b""
    for i in range(n):
        s = slice(i * page_size, (i + 1) * page_size)
        h = hashlib.blake2b(
            h + np.ascontiguousarray(ids_row[s]).tobytes()
            + np.ascontiguousarray(mask_row[s]).tobytes(),
            digest_size=16).digest()
        out.append(h)
    return out


class _PrefixNode:
    """One cached prompt block: its chain hash, the physical page holding
    its KV, the tree edges (parent/children — eviction must drop a node's
    now-unreachable subtree), and the block CONTENT (ids + mask), kept so
    a divergent request can find the child with the longest common token
    prefix and fork its page copy-on-write."""

    __slots__ = ("key", "page", "parent", "children", "ids", "mask")

    def __init__(self, key: bytes, page: int, parent, ids, mask):
        self.key = key
        self.page = page
        self.parent = parent
        self.children: dict = {}
        self.ids = ids
        self.mask = mask


@dataclasses.dataclass
class PrefixMatch:
    """A submit-time cache verdict: positions [0, tokens) of the padded row
    are served by `pages` (fully shared, pinned) plus — when the divergence
    point is mid-page — a copy-on-write fork of `fork_src` for positions
    [len(pages) * page_size, tokens). `new_demand` pages were reserved on
    top; `hashes` carries the full block-hash chain for registration at
    prefill completion."""

    tokens: int
    pages: list
    hashes: list
    fork_src: int | None
    new_demand: int
    forked: bool = False   # engine bookkeeping: fork pin already released


class PagedKVCache:
    def __init__(self, cfg: LlamaConfig, max_slots: int, max_len: int,
                 page_size: int, num_pages: int, quant: str = "fp",
                 prefix_cache: bool = False, *, device: str | torch.device = "cuda"):
        if max_slots < 1:
            raise ValueError(f"max_slots must be >= 1, got {max_slots}")
        if page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {page_size}")
        if max_len % page_size:
            raise ValueError(f"max_len {max_len} must be a multiple of "
                             f"page_size {page_size}")
        if num_pages < max_len // page_size:
            raise ValueError(
                f"num_pages {num_pages} cannot hold even one full-length "
                f"request ({max_len // page_size} pages)")
        if quant not in ("fp", "int8"):
            raise ValueError(f"quant must be 'fp' or 'int8', got {quant!r}")
        self.cfg = cfg
        self.max_slots = max_slots
        self.max_len = max_len
        self.page_size = page_size
        self.num_pages = num_pages
        self.quant = quant
        self.prefix_cache = prefix_cache
        self.pages_per_slot = max_len // page_size
        self.garbage_page = num_pages

        self.pool = decode.init_page_pool(cfg, num_pages, page_size, quant, device=device)
        self.kv_mask = torch.zeros((max_slots, max_len), dtype=torch.int32, device=device)
        self.page_table = np.full((max_slots, self.pages_per_slot),
                                  self.garbage_page, np.int32)

        self._lock = threading.Lock()
        self._free_slots = list(range(max_slots - 1, -1, -1))  # pop -> lowest
        self._free_pages = list(range(num_pages - 1, -1, -1))
        self._owned: dict[int, list[int]] = {}
        self._slot_reserved: dict[int, int] = {}
        self._slot_reserved_total = 0  # sum of _slot_reserved (int reads are
        self._queued_reserved = 0      # race-safe for lock-free gauges;
        # pages promised to still-queued requests — iterating the dict from
        # another thread would not be)
        self._owned_total = 0          # pages backing slot reservations
        # -- prefix cache (all empty forever when prefix_cache is off) ------
        self._index: dict[bytes, _PrefixNode] = {}   # chain hash -> node
        self._root = _PrefixNode(b"", -1, None, None, None)
        self._page_node: dict[int, _PrefixNode] = {}  # page -> its node
        self._ref: dict[int, int] = {}  # page -> mappings + submit pins
        self._idle: "OrderedDict[int, None]" = OrderedDict()  # ref-0 LRU
        self._shared: dict[int, list[int]] = {}  # slot -> mapped front pages
        self._held = 0                 # distinct non-owned pages with ref>=1
        self.cow_forks = 0             # cumulative copy-on-write forks
        self.prefix_evictions = 0      # index nodes dropped by LRU eviction
        self.assignments: list[tuple[int, str]] = []
        self.allocations = 1          # the pool is allocated ONCE
        self.page_allocations = 0     # cumulative page hand-outs (reuse proof)
        # request-observatory hook (serve/reqtrace.py): called as
        # `alloc_listener(slot, pages)` AFTER the lock is released whenever
        # ensure_capacity hands out physical pages, so the engine can
        # attribute every allocation to the slot's owning request. None
        # (the default) costs one predicted-false branch per call.
        self.alloc_listener = None

    # -- gauges ------------------------------------------------------------

    @property
    def free_count(self) -> int:
        return len(self._free_slots)

    @property
    def active_count(self) -> int:
        return self.max_slots - len(self._free_slots)

    @property
    def pages_free(self) -> int:
        return len(self._free_pages)

    @property
    def pages_used(self) -> int:
        """Physically allocated pages, each counted ONCE no matter how many
        slot rows map it (shared prefix pages included — they hold live
        KV); idle cached pages count too until eviction frees them."""
        return self.num_pages - len(self._free_pages)

    @property
    def pages_cached(self) -> int:
        """Pages registered in the prefix index (shared-held + idle)."""
        return len(self._page_node)

    @property
    def pages_reserved(self) -> int:
        """Pages promised to queued + admitted requests. Under prefix
        sharing this counts only NEW pages (shared pages cost 0 — the
        cache-aware admission math), which with the cache off is every
        page, exactly the cache-off number."""
        return self._queued_reserved + self._slot_reserved_total

    @property
    def reserved_unbacked(self) -> int:
        """Pages promised (admission control) but not yet physically
        allocated — the reservation-vs-allocation gap. Counted against the
        pages actually backing reservations (`_owned_total`), NOT raw pool
        occupancy: a shared prefix page backs no reservation and must not
        hide the gap (refcount-aware; identical to used-based accounting
        when nothing is cached). Every backed page counts against some
        slot's reservation, so this is never negative."""
        return max(self.pages_reserved - self._owned_total, 0)

    @property
    def fragmentation(self) -> float:
        """Fraction of the promised capacity that is NOT backed by tokens:
        0.0 = every reserved page holds written KV (dense-equivalent),
        approaching 1.0 = the pool is committed to worst-case demand that
        never materialized — exactly the over-reservation the paged cache
        exists to avoid paying in device memory, surfaced as a number so the
        operator can size num_pages against measured (not worst-case)
        demand (docs/OBSERVABILITY.md "Memory")."""
        reserved = self.pages_reserved
        return self.reserved_unbacked / reserved if reserved else 0.0

    def page_bytes(self) -> int:
        """Resident bytes of ONE pool page (int8 scales included) — what a
        unit of the reservation gap costs if it were backed."""
        one = paged_pool_bytes(self.cfg, 1, self.page_size, self.quant)
        zero = paged_pool_bytes(self.cfg, 0, self.page_size, self.quant)
        return one - zero  # difference cancels the garbage-page constant

    def fragmentation_gauges(self) -> dict:
        """The page-pool occupancy snapshot `/healthz` and the serve
        timeline publish each tick."""
        out = {
            "pages_free": self.pages_free,
            "pages_used": self.pages_used,
            "pages_reserved": self.pages_reserved,
            "reserved_unbacked": self.reserved_unbacked,
            "fragmentation": round(self.fragmentation, 4),
            "reserved_gap_bytes": self.reserved_unbacked * self.page_bytes(),
        }
        if self.prefix_cache:
            out["pages_cached"] = self.pages_cached
        return out

    def demand_pages(self, bucket: int, max_new_tokens: int) -> int:
        return page_demand(bucket, max_new_tokens, self.page_size)

    # -- reservation (admission control; any thread) -----------------------

    def _committed_locked(self) -> int:
        """Pages the pool is committed to: reservations (queued + per-slot)
        plus cached pages currently HELD by a mapping or pin — everything
        that is not free-or-evictable. `committed <= num_pages` is the
        invariant that keeps `_alloc_page_locked` infallible for admitted
        requests; with the prefix cache off `_held` is always 0 and this
        is exactly the cache-off reservation check."""
        return self._queued_reserved + self._slot_reserved_total + self._held

    def reserve(self, n: int) -> bool:
        """Commit `n` pages to a not-yet-admitted request; False when the
        pool cannot cover it on top of everything already promised — the
        refusal signal, instead of admitting and failing mid-decode."""
        with self._lock:
            if self._committed_locked() + n > self.num_pages:
                return False
            self._queued_reserved += n
            return True

    def unreserve(self, n: int) -> None:
        with self._lock:
            if n > self._queued_reserved:
                raise ValueError(f"unreserve({n}) exceeds queued reservation "
                                 f"{self._queued_reserved}")
            self._queued_reserved -= n

    # -- prefix cache: match / pin / register / evict -----------------------

    def _pin_locked(self, page: int) -> None:
        r = self._ref.get(page, 0)
        if r == 0:
            self._held += 1
            self._idle.pop(page, None)
        self._ref[page] = r + 1

    def _unpin_locked(self, page: int) -> None:
        r = self._ref[page] - 1
        if r:
            self._ref[page] = r
            return
        del self._ref[page]
        self._held -= 1
        if page in self._page_node:
            self._idle[page] = None        # most-recently-used LRU end
        else:
            # de-indexed (an evicted subtree) while still held: the last
            # mapping just dropped — straight back to the free list
            self._free_pages.append(page)
            self._free_pages.sort(reverse=True)

    def unpin_page(self, page: int) -> None:
        """Release one hold on a cached page (the engine's fork-source
        release once `decode.copy_page` has run)."""
        with self._lock:
            self._unpin_locked(page)

    def _alloc_page_locked(self) -> int:
        if not self._free_pages:
            self._evict_lru_locked()
        return self._free_pages.pop()

    def _evict_lru_locked(self) -> None:
        """Free at least one page by evicting the least-recently-idle
        cached page AND de-indexing its subtree (descendants hang off the
        evicted chain hash — unreachable once it is gone). Subtree pages
        still held by live mappings lose cached status and return to the
        free list when their last hold drops; idle ones free now. The
        committed invariant guarantees this is only ever called when
        something IS evictable."""
        if not self._idle:
            raise RuntimeError(
                "page pool empty with nothing evictable — committed-pages "
                "accounting bug")
        page, _ = self._idle.popitem(last=False)   # least recently idle
        node = self._page_node[page]
        if node.parent is not None:
            node.parent.children.pop(node.key, None)
        stack = [node]
        while stack:
            n = stack.pop()
            stack.extend(n.children.values())
            n.children = {}
            self._index.pop(n.key, None)
            self._page_node.pop(n.page, None)
            self.prefix_evictions += 1
            if self._ref.get(n.page, 0) == 0:
                self._idle.pop(n.page, None)
                self._free_pages.append(n.page)
        self._free_pages.sort(reverse=True)

    def match_and_reserve(self, request_id: str, ids_row: np.ndarray,
                          mask_row: np.ndarray,
                          demand: int) -> PrefixMatch | None:
        """The cache-aware admission check: walk the longest cached chain
        for this padded row, PIN the matched pages (a hold that keeps them
        from evicting between submit and admission), pick a copy-on-write
        fork source when the divergence lands mid-page, and reserve only
        the remaining new-page demand. Returns None — with every pin
        undone — when the pool cannot cover the new demand (the 429
        refusal, now sharing-aware: a fully cached prompt costs ~0 new
        pages)."""
        ids_row = np.ascontiguousarray(np.asarray(ids_row,
                                                  np.int32).reshape(-1))
        mask_row = np.ascontiguousarray(np.asarray(mask_row,
                                                   np.int32).reshape(-1))
        ps = self.page_size
        hashes = chain_hashes(ids_row, mask_row, ps)
        nblocks = len(hashes)
        bucket = len(ids_row)
        with self._lock:
            matched = 0
            while matched < nblocks and hashes[matched] in self._index:
                matched += 1
            fork_src = None
            if matched == nblocks:
                # full-row match: at least one position must recompute so
                # the engine can sample the first token — fork the last
                # page and recompute exactly position bucket-1
                matched -= 1
                tokens = bucket - 1
                if tokens % ps:
                    fork_src = self._index[hashes[matched]].page
            else:
                tokens = matched * ps
                parent = (self._index[hashes[matched - 1]] if matched
                          else self._root)
                s = slice(matched * ps, (matched + 1) * ps)
                blk_ids, blk_mask = ids_row[s], mask_row[s]
                best = 0
                for child in parent.children.values():
                    same = (child.ids == blk_ids) & (child.mask == blk_mask)
                    c = ps if same.all() else int(np.argmin(same))
                    c = min(c, ps - 1)  # a full block match would have
                    if c > best:        # matched by hash; cap defensively
                        best, fork_src = c, child.page
                if fork_src is not None:
                    tokens += best

            pinned = [self._index[hashes[i]].page for i in range(matched)]
            for p in pinned:
                self._pin_locked(p)
            if fork_src is not None:
                self._pin_locked(fork_src)
            new_demand = demand - matched
            if self._committed_locked() + new_demand > self.num_pages:
                for p in pinned:
                    self._unpin_locked(p)
                if fork_src is not None:
                    self._unpin_locked(fork_src)
                return None
            self._queued_reserved += new_demand
        return PrefixMatch(tokens=tokens, pages=pinned, hashes=hashes,
                           fork_src=fork_src, new_demand=new_demand)

    def cancel_match(self, match: PrefixMatch) -> None:
        """A match that will never be admitted (queue drop, shutdown,
        abandoned while queued): release the submit-time pins and its
        reservation."""
        with self._lock:
            for p in match.pages:
                self._unpin_locked(p)
            if match.fork_src is not None and not match.forked:
                self._unpin_locked(match.fork_src)
            if match.new_demand > self._queued_reserved:
                raise ValueError(
                    f"cancel_match({match.new_demand}) exceeds queued "
                    f"reservation {self._queued_reserved}")
            self._queued_reserved -= match.new_demand

    def fork_page(self, slot: int, src: int) -> None:
        """Copy-on-write fork: allocate the slot's next page and clone the
        cached source page into it, so the span prefill can overwrite only
        the divergent suffix. The caller (engine) unpins `src` afterwards;
        the clone is a plain owned page until registration."""
        base = len(self._shared.get(slot, ()))
        self.ensure_capacity(slot, base * self.page_size + 1)
        dst = int(self.page_table[slot, base])
        self.pool = decode.copy_page(self.pool, src, dst)
        self.cow_forks += 1

    def register_prefix(self, slot: int, hashes: list, ids_row: np.ndarray,
                        mask_row: np.ndarray) -> int:
        """Index the slot's freshly prefilled prompt pages under their
        chain hashes so later requests can map them read-only. Registered
        pages move from the slot's owned list to its shared mapping (ref 1
        — the slot's own hold; their reservation is spent, and they
        survive `release` as cached pages). A block whose hash landed in
        the index while this prompt prefilled adopts the canonical page
        and frees its private twin instead (identical content by the chain
        property). Returns how many new blocks were registered."""
        if not self.prefix_cache:
            return 0
        ps = self.page_size
        ids_row = np.asarray(ids_row, np.int32).reshape(-1)
        mask_row = np.asarray(mask_row, np.int32).reshape(-1)
        with self._lock:
            shared = self._shared.setdefault(slot, [])
            owned = self._owned[slot]
            parent = self._root
            registered = 0
            resort = False
            for i, key in enumerate(hashes):
                node = self._index.get(key)
                if i < len(shared) and (node is None or node.page
                                        != shared[i]):
                    # a mapped prefix page was de-indexed mid-flight (an
                    # idle ancestor's eviction cascaded): the chain above
                    # is gone, deeper registrations would be unreachable
                    break
                if i < len(shared):
                    parent = node
                    continue
                if node is not None:
                    dup = owned.pop(0)
                    self._free_pages.append(dup)
                    resort = True
                    self._owned_total -= 1
                    self._pin_locked(node.page)
                    self.page_table[slot, i] = node.page
                    shared.append(node.page)
                    self._slot_reserved[slot] -= 1
                    self._slot_reserved_total -= 1
                    parent = node
                    continue
                s = slice(i * ps, (i + 1) * ps)
                page = owned.pop(0)
                node = _PrefixNode(key, page, parent, ids_row[s].copy(),
                                   mask_row[s].copy())
                parent.children[key] = node
                self._index[key] = node
                self._page_node[page] = node
                self._ref[page] = 1        # the slot's own mapping
                self._held += 1
                self._owned_total -= 1
                shared.append(page)
                self._slot_reserved[slot] -= 1
                self._slot_reserved_total -= 1
                parent = node
                registered += 1
            if resort:
                self._free_pages.sort(reverse=True)
        return registered

    # -- lifecycle (the engine loop thread) --------------------------------

    def acquire(self, request_id: str, reserved_pages: int,
                match: PrefixMatch | None = None) -> int | None:
        """A free slot carrying the request's page reservation (moved from
        the queued pot), or None when every slot is occupied. With a
        `match`, the submit-time pins become the slot's read-only mappings:
        the shared pages land at the FRONT of the table row, owned pages
        fill in behind them."""
        with self._lock:
            if not self._free_slots:
                return None
            slot = self._free_slots.pop()
            self._queued_reserved -= reserved_pages
            self._slot_reserved[slot] = reserved_pages
            self._slot_reserved_total += reserved_pages
            self._owned[slot] = []
            if match is not None and match.pages:
                self._shared[slot] = list(match.pages)
                self.page_table[slot, :len(match.pages)] = match.pages
            else:
                self._shared[slot] = []
            self.assignments.append((slot, request_id))
            return slot

    def ensure_capacity(self, slot: int, tokens: int) -> int:
        """Allocate physical pages until logical positions [0, tokens) are
        backed; returns how many pages were newly allocated. Shared prefix
        pages already back the row's front, so only the gap past them
        allocates. Infallible for admitted requests (`tokens` within the
        reservation + mapping); anything past it is a scheduler bug and
        raises."""
        need = -(-tokens // self.page_size)
        with self._lock:
            owned = self._owned[slot]
            base = len(self._shared.get(slot, ()))
            if need - base > self._slot_reserved[slot]:
                raise RuntimeError(
                    f"slot {slot} needs {need - base} new pages but "
                    f"reserved only {self._slot_reserved[slot]} — page "
                    f"accounting bug")
            grew = 0
            while base + len(owned) < need:
                page = self._alloc_page_locked()  # free, or evict-then-pop
                self.page_table[slot, base + len(owned)] = page
                owned.append(page)
                self._owned_total += 1
                self.page_allocations += 1
                grew += 1
        if grew and self.alloc_listener is not None:
            self.alloc_listener(slot, grew)
        return grew

    def release(self, slot: int) -> None:
        with self._lock:
            if slot in self._free_slots or not 0 <= slot < self.max_slots:
                raise ValueError(f"release of slot {slot} not currently held")
            for page in self._shared.pop(slot, ()):
                self._unpin_locked(page)
            freed = self._owned.pop(slot, ())
            self._free_pages.extend(freed)
            self._owned_total -= len(freed)
            self._free_pages.sort(reverse=True)   # keep lowest-first reuse
            self.page_table[slot, :] = self.garbage_page
            self._slot_reserved_total -= self._slot_reserved.pop(slot, 0)
            self._free_slots.append(slot)
            self._free_slots.sort(reverse=True)

    # -- device-state plumbing --------------------------------------------

    def admit(self, slot: int, prefill_out: dict) -> None:
        """Splice a bucket-sized `prefill_prompt` result (b == 1, max_len ==
        bucket) into the slot's pages — the single-shot (bit-exact) path."""
        bucket = prefill_out["kv_mask"].shape[1]
        self.ensure_capacity(slot, bucket)
        n = bucket // self.page_size
        self.pool, self.kv_mask = decode.write_pages(
            self.pool, self.kv_mask, slot, self.page_table[slot, :n],
            prefill_out["cache"], prefill_out["kv_mask"])

    def reset_mask_row(self, slot: int) -> None:
        """Kill the previous occupant's logical mask before a CHUNKED
        prefill starts writing the row incrementally."""
        self.kv_mask = decode.reset_kv_mask_row(self.kv_mask, slot)

    def set_mask_row_prefix(self, slot: int, mask_row: np.ndarray,
                            tokens: int) -> None:
        """Warm admission: mark the shared positions [0, tokens) valid per
        the request's own mask and everything past them dead, in one
        row rewrite — the prefix-cache counterpart of
        `reset_mask_row` (the span prefill fills in the tail)."""
        row = np.zeros((1, self.max_len), np.int32)
        row[0, :tokens] = np.asarray(mask_row, np.int32).reshape(-1)[:tokens]
        self.kv_mask = decode.set_kv_mask_row(self.kv_mask, slot, row)

    def update_from_step(self, step_out: dict) -> None:
        """Adopt the pool/kv_mask a `paged_decode_step` returned (the same
        tensors, updated in place)."""
        self.pool = step_out["pool"]
        self.kv_mask = step_out["kv_mask"]

    def reused_slot_count(self) -> int:
        seen: dict[int, int] = {}
        for slot, _ in self.assignments:
            seen[slot] = seen.get(slot, 0) + 1
        return sum(1 for n in seen.values() if n > 1)
