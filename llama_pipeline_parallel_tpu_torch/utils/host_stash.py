"""Host-memory staging for the pipeline's residuals: pinned rings and a copy stream.

The counterpart of llama_pipeline_parallel_tpu/utils/host_stash.py, which
keeps two of the schedules' residual stores in host memory behind
asynchronous copies (PipeOffload, arxiv 2503.01328): the zb1 W queue (each B
unit's (chunk input, cotangent) pair, read only by its W unit) and the stage-
input buffer of the unit schedules (read only by the unit's B, several ticks
later). parallel/pipeline.py's interpreter uses them under
`offload.wgrad_stash`, `offload.activations` and solver sequences with
offloaded units.

On the card a store is a pinned host ring, [n_slots + 1, *shape], and every
copy runs on one side stream per device (`copy_stream`): a push (device to
host) waits for the compute stream's work so far (which made the value) and
keeps the value's memory alive until the copy ends; a pop (host to device)
lands in a new device tensor, and the compute stream waits for it only when
it reads it (`ready`). One stream serves both directions, so a slot is never
rewritten before an earlier pop of it has landed. The copies move bytes, so
the values are the same bits whether a store is tiered or not.

`stash_push` keeps the reference's one garbage slot: a write whose `valid`
is false lands in the ring's last slot and never clobbers a live one.

`transfers_enabled(device)` is true exactly when the device is cuda. On the
CPU the tier is an identity copy (the rings are ordinary host tensors, and
`to_host` / `to_device` return their argument): that is the mode the caller
asked for, as the reference's `supports_host_memory()` gate keeps XLA-CPU's
one address space. On the card a failure to pin or to copy raises: the store
never silently stays on the device.

`measure_transfer_bandwidth` reads the link both offload tiers share.
"""

from __future__ import annotations

import time

import torch

_STREAMS: dict[torch.device, torch.cuda.Stream] = {}


def transfers_enabled(device: str | torch.device) -> bool:
    """Whether stores on `device` live in pinned host memory behind real
    copies (cuda), or stay where they are (the CPU)."""
    return torch.device(device).type == "cuda"


def copy_stream(device: torch.device) -> torch.cuda.Stream:
    """The side stream of `device`'s stash copies (one per device)."""
    device = torch.device(device)
    stream = _STREAMS.get(device)
    if stream is None:
        stream = _STREAMS[device] = torch.cuda.Stream(device)
    return stream


def to_host(t: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """`t` in host memory: copied on the copy stream into `out` (pinned;
    a new pinned tensor when None) after the compute stream's work so far.
    The identity on the CPU (into `out` when given)."""
    if not t.is_cuda:
        if out is None:
            return t
        out.copy_(t)
        return out
    if out is None:
        out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    stream = copy_stream(t.device)
    stream.wait_stream(torch.cuda.current_stream(t.device))
    with torch.cuda.stream(stream):
        out.copy_(t, non_blocking=True)
    t.record_stream(stream)  # its memory is not reused before the copy ends
    return out


def to_device(t: torch.Tensor, device: str | torch.device) -> tuple[torch.Tensor, object]:
    """(a copy of host tensor `t` on `device`, its ready event): on the card
    copied on the copy stream, queued after the compute stream's work so far
    (the new tensor's memory may have been freed by it); pass the pair to
    `ready` before reading it. The identity on the CPU (event None)."""
    device = torch.device(device)
    if device.type != "cuda":
        return t, None
    out = torch.empty(t.shape, dtype=t.dtype, device=device)
    stream = copy_stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        out.copy_(t, non_blocking=True)
        event = torch.cuda.Event()
        event.record(stream)
    return out, event


def ready(pair: tuple[torch.Tensor, object]) -> torch.Tensor:
    """The tensor of a `to_device` / `stash_pop` pair, once the compute
    stream may read it."""
    t, event = pair
    if event is not None:
        torch.cuda.current_stream(t.device).wait_event(event)
    return t


# ---------------------------------------------------------------------------
# Host-resident rings (the schedules' residual stores)
# ---------------------------------------------------------------------------

def stash_init(n_slots: int, shape: tuple[int, ...], dtype: torch.dtype,
               device: str | torch.device) -> torch.Tensor:
    """A [n_slots + 1, *shape] ring for values of `device`: pinned host
    memory on the card, an ordinary tensor on the CPU. Slot n_slots is the
    garbage slot that invalid writes land in (stash_push)."""
    pin = transfers_enabled(device)
    return torch.zeros((n_slots + 1,) + tuple(shape), dtype=dtype, pin_memory=pin,
                       device="cpu")


def stash_push(buf: torch.Tensor, value: torch.Tensor, slot: int, valid: bool = True) -> None:
    """Write `value` into `buf[slot]` when `valid`, else into the garbage
    slot: clipped warmup and drain indices never clobber a live slot."""
    n_slots = buf.shape[0] - 1
    if valid and not 0 <= slot < n_slots:
        raise IndexError(f"slot {slot} outside the ring's {n_slots} slots")
    to_host(value, buf[slot if valid else n_slots])


def stash_pop(buf: torch.Tensor, slot: int, device: str | torch.device
              ) -> tuple[torch.Tensor, object]:
    """`buf[slot]` back on `device` (a `to_device` pair): dispatch it as early
    as its slot is known, so the copy runs behind the compute queued before
    its first use. A copy on the CPU too: a later push may reuse the slot."""
    if not transfers_enabled(device):
        return buf[slot].clone(), None
    return to_device(buf[slot], device)


# ---------------------------------------------------------------------------
# The link's bandwidth
# ---------------------------------------------------------------------------

def measure_transfer_bandwidth(nbytes: int = 1 << 28, reps: int = 3,
                               device: str | torch.device = "cuda") -> dict:
    """Device-to-host and host-to-device GB/s (1e9 bytes a second) of the
    link, pinned host memory, `reps` copies of `nbytes` each way after a
    warm-up, synchronised. On the CPU (`device="cpu"`) it reads memcpy
    between two host tensors: the tiers are identities there."""
    device = torch.device(device)
    on_card = device.type == "cuda"
    n = max(nbytes // 4, 1)
    host = torch.ones(n, dtype=torch.float32, pin_memory=on_card)
    dev = torch.empty(n, dtype=torch.float32, device=device)

    def rate(dst, src) -> float:
        dst.copy_(src, non_blocking=on_card)  # warm-up
        if on_card:
            torch.cuda.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(reps):
            dst.copy_(src, non_blocking=on_card)
        if on_card:
            torch.cuda.synchronize(device)
        return reps * src.numel() * 4 / (time.perf_counter() - t0) / 1e9

    h2d = rate(dev, host)
    d2h = rate(host, dev)
    return {"h2d_gbps": h2d, "d2h_gbps": d2h, "probe_mb": n * 4 / 1e6, "pinned_host": on_card}
