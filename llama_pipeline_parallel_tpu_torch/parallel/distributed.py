"""Process-group bring-up, the collectives the trainer uses, the host barrier
and the stop vote.

The counterpart of llama_pipeline_parallel_tpu/parallel/distributed.py over
`torch.distributed`: `initialize_distributed` joins the process group that a
launcher describes in the environment (`python -m torch.distributed.run`
sets `RANK`, `WORLD_SIZE`, `MASTER_ADDR` and `MASTER_PORT`), with `gloo` on
the CPU and `nccl` on cards; a lone process initialises nothing.

`LPT_DIST_BACKEND=gloo` is the one other choice, asked for explicitly: ranks
on cards then talk over gloo and share card `LOCAL_RANK % device_count`, so a
run of several processes can be driven on a machine with fewer cards than
processes. gloo has no CUDA point-to-point, so every tensor on a card that a
collective or a send carries is staged through pinned host memory; the
seconds and bytes of that staging are counted in `staging` (this mode's
cost, not an NCCL figure). Without the variable nothing is staged, and a
second rank on a card that is taken fails as NCCL fails.

Besides the launcher's group, `initialize_distributed` creates two gloo
groups over every process: one for host traffic of the main thread (the stop
vote, a verdict broadcast), one for the checkpoint commit (its barriers, and
the pieces of the state that process 0 asks the others for: ckpt/gather.py),
which may run on the commit thread while the main thread trains (`barrier`). `barrier` waits for every process
and raises BarrierTimeoutError when a peer does not arrive within its
deadline. `should_stop` is the reference's `_should_stop`: an all-gather of
each process's flag, true everywhere when any process saw a signal.

Sequence parallelism's collectives (parallel/ring_attention.py,
parallel/ulysses.py) are `ring_shift` (each process of a group sends to the
next and receives from the previous, over `batch_p2p`), `all_to_all` (the
tiled all-to-all, split along one dim and joined along another) and
`all_gather_dim` (the tiled all-gather along a dim); staged like the rest.
"""

from __future__ import annotations

import datetime
import os
import time

import torch
import torch.distributed as dist

from llama_pipeline_parallel_tpu_torch.utils import faults, retry
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

_DEFAULT_BARRIER_TIMEOUT_S = 1800.0
ENV_BACKEND = "LPT_DIST_BACKEND"

# the gloo groups of initialize_distributed: main-thread host traffic and the
# commit's barriers (None until then, and in a lone process)
_groups: dict[str, object] = {}
# what staging CUDA tensors through host memory for gloo has cost so far, in
# all and by group label; the wall seconds of the collectives by group label
staging = {"seconds": 0.0, "bytes": 0}
staging_by: dict[str, dict] = {}
collective_s: dict[str, float] = {}
_labels: dict = {}


class BarrierTimeoutError(RuntimeError):
    """The barrier's deadline expired: a peer is dead or hung. Never
    retried: peers that already passed will not re-enter it."""


class TransientBarrierError(RuntimeError):
    """A barrier attempt failed before it reached its peers (the `barrier`
    fault site's injected error): retried, as the reference retries it."""


def _env_int(name: str) -> int | None:
    # `or None`: launchers that export unset shell variables give ""
    value = os.environ.get(name) or None
    return None if value is None else int(value)


def initialize_distributed(device: str | torch.device = "cuda") -> None:
    """Join the launcher's process group, once: `gloo` for a CPU run,
    `nccl` on cards (each rank on card `LOCAL_RANK`), or gloo on cards with
    LPT_DIST_BACKEND=gloo (each rank on card `LOCAL_RANK % device_count`,
    tensors staged through host memory). The choice is logged. Nothing
    happens for a lone process (no `WORLD_SIZE`, or 1). A rank without a
    world size, or a world size without `MASTER_ADDR`, is refused: running N
    independent copies of one training run is the worst outcome of a
    half-configured launcher."""
    if dist.is_initialized():
        return
    asked = os.environ.get(ENV_BACKEND) or None
    if asked not in (None, "gloo"):
        raise ValueError(f"{ENV_BACKEND}={asked!r}: the only choice is 'gloo' (unset: gloo on "
                         f"the CPU, nccl on cards)")
    world, rank = _env_int("WORLD_SIZE"), _env_int("RANK")
    if world is None or world == 1:
        if rank:
            raise ValueError(f"RANK={rank} but WORLD_SIZE is {world}; set both, or neither "
                             f"for a one-process run")
        return
    if rank is None or not os.environ.get("MASTER_ADDR"):
        raise ValueError(f"WORLD_SIZE={world} needs RANK and MASTER_ADDR/MASTER_PORT too "
                         f"(python -m torch.distributed.run sets all of them)")
    device = torch.device(device)
    local = _env_int("LOCAL_RANK") or 0
    if device.type != "cuda":
        backend, card = "gloo", None
    elif asked == "gloo":
        backend, card = "gloo", local % torch.cuda.device_count()
    else:
        backend, card = "nccl", local
    if card is not None:
        torch.cuda.set_device(card)
    dist.init_process_group(backend=backend, rank=rank, world_size=world)
    _groups["host"] = dist.new_group(backend="gloo")
    _groups["commit"] = dist.new_group(backend="gloo")
    where = "" if card is None else f" on card {card}"
    how = (f" ({ENV_BACKEND}=gloo: tensors on cards staged through host memory)"
           if asked == "gloo" and card is not None else "")
    logger.info("torch.distributed initialised: process %d/%d (%s)%s%s", rank, world, backend,
                where, how)


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def host_group():
    """The gloo group over every process for host (CPU) tensors."""
    return _groups.get("host")


def commit_group():
    """The gloo group over every process of the checkpoint commit."""
    return _groups.get("commit")


def label_group(group, label: str) -> None:
    """Name `group` in `staging_by` and `collective_s`."""
    if group is not None:
        _labels[group] = label


def _label(group) -> str:
    return _labels.get(group, "other")


def _staged(t: torch.Tensor, group) -> bool:
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _count(group, t0: float, nbytes: int) -> None:
    seconds = time.perf_counter() - t0
    staging["seconds"] += seconds
    staging["bytes"] += nbytes
    by = staging_by.setdefault(_label(group), {"seconds": 0.0, "bytes": 0})
    by["seconds"] += seconds
    by["bytes"] += nbytes


def _to_host(t: torch.Tensor, group=None) -> torch.Tensor:
    t0 = time.perf_counter()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    _count(group, t0, t.numel() * t.element_size())
    return out


def _from_host(t: torch.Tensor, host: torch.Tensor, group=None) -> None:
    t0 = time.perf_counter()
    t.copy_(host)
    _count(group, t0, t.numel() * t.element_size())


def _timed(group, t0: float) -> None:
    label = _label(group)
    collective_s[label] = collective_s.get(label, 0.0) + time.perf_counter() - t0


def all_reduce(t: torch.Tensor, group=None, op=dist.ReduceOp.SUM) -> torch.Tensor:
    """Reduce `t` over `group` in place by `op` (the sum by default; None:
    nothing to reduce) and return it."""
    if group is None:
        return t
    t0 = time.perf_counter()
    if _staged(t, group):
        host = _to_host(t, group)
        dist.all_reduce(host, op=op, group=group)
        _from_host(t, host, group)
    else:
        dist.all_reduce(t, op=op, group=group)
    _timed(group, t0)
    return t


def broadcast(t: torch.Tensor, src: int, group=None) -> torch.Tensor:
    """`t` from global rank `src` to every process of `group`, in place."""
    if group is None:
        return t
    t0 = time.perf_counter()
    if _staged(t, group):
        host = _to_host(t, group)
        dist.broadcast(host, src=src, group=group)
        _from_host(t, host, group)
    else:
        dist.broadcast(t, src=src, group=group)
    _timed(group, t0)
    return t


def all_gather(t: torch.Tensor, group) -> list[torch.Tensor]:
    """Every process of `group`'s `t` (same shape everywhere), in group rank
    order, on `t`'s device."""
    t0 = time.perf_counter()
    staged = _staged(t, group)
    src = _to_host(t, group) if staged else t.contiguous()
    parts = [torch.empty_like(src) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, src, group=group)
    if staged:
        out = [torch.empty_like(t) for _ in parts]
        for o, p in zip(out, parts):
            _from_host(o, p, group)
        parts = out
    _timed(group, t0)
    return parts


def batch_p2p(sends: list[tuple[torch.Tensor, int, int]],
              recvs: list[tuple[torch.Tensor, int, int]], group=None) -> None:
    """Post every (tensor, global peer rank, tag) send and receive together
    (`dist.batch_isend_irecv`) and wait for all of them; receives land in
    their tensors."""
    t0 = time.perf_counter()
    staged = any(_staged(t, group) for t, _, _ in sends + recvs)
    ops, landing = [], []
    for t, peer, tag in sends:
        ops.append(dist.P2POp(dist.isend, _to_host(t, group) if staged else t, peer,
                              group=group, tag=tag))
    for t, peer, tag in recvs:
        buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=True) if staged else t
        landing.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, peer, group=group, tag=tag))
    if not ops:
        return
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if staged:
        for t, buf in landing:
            _from_host(t, buf, group)
    _timed(group, t0)


def group_place(group) -> tuple[int, int]:
    """(this process's index in `group`, the group's size); (0, 1) for no
    group."""
    if group is None:
        return 0, 1
    return dist.get_rank(group), dist.get_world_size(group)


def ring_shift(tensors: list[torch.Tensor], group, shift: int = 1) -> list[torch.Tensor]:
    """Each process of `group` sends its `tensors` to the process `shift`
    places on in the group's order (i -> (i + shift) % n) and returns what
    the process `shift` places back sent, in new tensors (batch_p2p, one tag
    a tensor). Without a group, the tensors themselves."""
    i, n = group_place(group)
    if n == 1 or shift % n == 0:
        return list(tensors)
    ranks = dist.get_process_group_ranks(group)
    dst, src = ranks[(i + shift) % n], ranks[(i - shift) % n]
    out = [torch.empty_like(t) for t in tensors]
    batch_p2p([(t.contiguous(), dst, tag) for tag, t in enumerate(tensors)],
              [(o, src, tag) for tag, o in enumerate(out)], group)
    return out


def all_to_all(t: torch.Tensor, group, split_dim: int, concat_dim: int) -> torch.Tensor:
    """The tiled all-to-all of `jax.lax.all_to_all(..., tiled=True)`: `t`
    cut into n equal blocks along `split_dim`, block j sent to the group's
    j-th process, and the blocks received from processes 0..n-1 joined
    along `concat_dim` (`dist.all_to_all_single` on the blocks stacked)."""
    _, n = group_place(group)
    if n == 1:
        return t
    t0 = time.perf_counter()
    send = torch.stack(t.chunk(n, dim=split_dim))
    staged = _staged(send, group)
    if staged:
        send = _to_host(send, group)
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=group)
    if staged:
        out = torch.empty(recv.shape, dtype=recv.dtype, device=t.device)
        _from_host(out, recv, group)
        recv = out
    _timed(group, t0)
    return torch.cat(recv.unbind(0), dim=concat_dim)


def all_gather_dim(t: torch.Tensor, group, dim: int) -> torch.Tensor:
    """Every process of `group`'s `t` joined along `dim` in group order
    (the tiled all-gather); `t` itself without a group."""
    if group_place(group)[1] == 1:
        return t
    return torch.cat(all_gather(t, group), dim=dim)


def should_stop(local_flag: bool) -> bool:
    """Agree on preemption across processes (the reference's `_should_stop`):
    an all-gather of every process's flag; true on every process when any
    one saw a signal (or, for any other verdict, raised its flag). Alone:
    the flag itself. Every process must call it at the same steps (a
    collective)."""
    if process_count() == 1:
        return local_flag
    flags = all_gather(torch.tensor([int(local_flag)], dtype=torch.int32), host_group())
    return bool(torch.cat(flags).any())


def shutdown() -> None:
    """Leave the process group at the end of a run (a no-op alone): every
    process waits for the others, then the groups are destroyed, so no
    communication thread outlives the interpreter."""
    if not dist.is_initialized():
        return
    barrier("shutdown")
    dist.destroy_process_group()
    _groups.clear()


def barrier(tag: str = "sync", timeout_s: float = _DEFAULT_BARRIER_TIMEOUT_S) -> None:
    """Wait for every process (a no-op alone), over the commit's gloo group,
    so the checkpoint commit thread can wait here while the main thread's
    collectives run. A peer that has not arrived within `timeout_s` raises
    BarrierTimeoutError naming `tag`.

    The `barrier` fault site fires inside each attempt, before the lone
    process's early-out (the reference's `host_barrier`): a `stall` rule
    delays the attempt, an `error` rule becomes TransientBarrierError, which
    is retried up to LPT_BARRIER_RETRIES times (default 1) under the shared
    backoff policy. The injected error is raised before this process enters
    the gloo barrier, so a retry re-enters the same barrier its peers wait
    in; a real failure inside gloo is never retried."""
    timeout = float(timeout_s)
    t0 = time.monotonic()
    state = {"attempt": 0}

    def wait_once():
        state["attempt"] += 1
        try:
            faults.fire("barrier", tag=tag)
        except faults.InjectedFault as e:
            raise TransientBarrierError(
                f"barrier {tag!r} failed after {time.monotonic() - t0:.1f}s (injected, "
                f"attempt {state['attempt']}): {e}") from e
        if process_count() == 1:
            return
        work = dist.barrier(group=commit_group(), async_op=True)
        try:
            done = work.wait(timeout=datetime.timedelta(seconds=timeout))
        except RuntimeError as e:
            raise BarrierTimeoutError(f"barrier {tag!r}: a peer did not arrive within "
                                      f"{timeout:.0f} s ({e})") from e
        if done is False:
            raise BarrierTimeoutError(f"barrier {tag!r}: a peer did not arrive within "
                                      f"{timeout:.0f} s")

    retries = int(os.environ.get("LPT_BARRIER_RETRIES", "1"))
    retry.retry_call(wait_once, retryable=(TransientBarrierError,),
                     policy=retry.RetryPolicy.from_env(max_attempts=max(retries, 0) + 1),
                     describe=f"barrier {tag!r}")
