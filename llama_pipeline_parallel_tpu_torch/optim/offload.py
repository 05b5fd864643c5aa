"""Host-offloaded AdamW: fp32 masters and moments in host DRAM, stepped by C++.

The counterpart of llama_pipeline_parallel_tpu/optim/offload.py, which
replaces the reference's ZeRO-offload arrangement (`offload_optimizer: device:
cpu` + DeepSpeedCPUAdam): the fp32 master params and Adam moments stay in host
memory, the card holds only the working copy in the compute dtype (bf16) and
the fp32 gradients, and each step moves the gradients down and the fresh
working copy up.

Leaves are a flat dict {name: tensor}: the canonical names at pp = 1, a
pipeline's `StageParams.flat()` names otherwise (the stages of this process:
under torch.distributed each process keeps and steps its own stages, the
reference's per-process shards).

The update is `csrc/host_adamw.cpp` (OpenMP + SIMD: the JAX package's
`adamw_step` and `l2_norm_sq` line for line, and `f32_to_bf16` with torch's
NaN), built at first use with `g++ -O3 -march=native -fopenmp
-shared -fPIC` into the port's build directory (ops/kernel_build.build_dir())
under a name hashed from source and flags, and loaded with ctypes. A failed
build or load raises: `adamw_plain` is the update's plain PyTorch twin, which
only the tests call. The library's OpenMP thread count is set explicitly on
the calling thread before every call: `threads` (default: this process's
CPU affinity), fewer for a piece under PER_THREAD elements a thread (a team
woken for a few thousand elements costs more than it saves, and its idle
threads spin on cores other processes need). The count is restored after
each call: the library runs on the OpenMP runtime that torch's intra-op pool
uses, so a count left set would be torch's thread count from then on.

On the card, the step streams piece by piece (`update_and_refresh`; a piece
is a leaf, or PIECE elements of a larger one: the update is elementwise):
- host state is pageable (never pinned); staging is a few reused pinned
  slots, two each way, each of one piece;
- each piece's gradient is copied down on a side stream after the backward
  (an event on the compute stream orders it), and the host waits on that
  piece's event only, then steps it while the next piece's copy is in flight;
- the stepped master is cast on the host (`f32_to_bf16`, round to nearest
  even) into a pinned slot and copied up into the working copy on another
  side stream, so piece i's upload overlaps piece i+1's AdamW;
- the uploads wait for the compute stream's work queued before the step (no
  upload overwrites a leaf the step still reads), and the compute stream
  waits for the last upload (the next step reads no stale leaf).
On the CPU the gradients are read in place and the working copy is written in
place: the copies the card needs are identities there.

The global norm: `device_norm` takes the caller's fp32 norm of the
gradients on the card (the trainer's default, `offload_device_norm`), so the
first leaf's AdamW need not wait for every gradient to come down; otherwise
(the host path) every gradient is streamed down once for an fp64 norm (the
pieces' sums of squares added in order) and again for the update, which
keeps host memory at two slots rather than a full gradient tree.

Data parallelism (dp > 1): the gradients the step reads are already summed
over the replicas. Without `dims` every replica keeps its whole leaves and
applies the same update (the replicated layout). With `dims` (the ZeRO-2
layout, `optimizer_offload_zero2`; the reference's `zero2_param_specs`,
whose placement is ZeRO-1's, optim/optimizer.zero1_dims) each replica keeps
of a split leaf only its 1/dp slice of the masters and moments, brings down
only that slice of the gradient, steps it, uploads its slice of the working
copy and all-gathers the leaf over `group` (the stage's dp group) once a
step; a leaf with no dim dp divides is kept whole on every replica. The
host-path norm counts each element once over the processes:
`counts_in_norm(name)` says whether this process counts a leaf (its own
slice, or a whole leaf on one replica and one tp rank, and on sp rank 0
only), and `reduce_norm_sq` adds the processes' sums. Sequence parallelism
adds no split: the sp peers of a stage hold the same masters and moments
and step them on the same sp-summed gradients; the ZeRO-2 layout stays
over dp.

`bind_fp32_grads` lets a model run on the working copy while each
parameter's gradient accumulates in fp32 on the card, over its microbatches
in order, as it does into the fp32 masters' `.grad` on the on-device path.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import hashlib
import math
import os
import subprocess
import threading
import time
from typing import Any, Callable

import torch

from llama_pipeline_parallel_tpu_torch.ops import kernel_build
from llama_pipeline_parallel_tpu_torch.optim.optimizer import (
    OptimizerConfig,
    dp_part,
    global_norm,
    warmup_decay_schedule,
)
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

Params = dict[str, torch.Tensor]

CSRC = os.path.join(kernel_build.CSRC_DIR, "host_adamw.cpp")
GXX_FLAGS = ("-O3", "-march=native", "-fopenmp", "-shared", "-fPIC")
# pinned staging slots each way: piece i's copy lands while piece i - 1 is
# stepped (down) or piece i - 1's upload is in flight while piece i is cast (up)
SLOTS = 2
# elements of the largest piece the link moves at once: 256 MiB of fp32, so a
# pipeline chunk's stacked layer leaf (LLaMA-7B: 8 x 4096 x 11008) streams in
# several pieces and the pinned staging stays at 1.5 GiB
PIECE = 1 << 26
# the least elements an OpenMP thread is given: a smaller piece runs on fewer
# threads (on one below this)
PER_THREAD = 1 << 20

_lib: ctypes.CDLL | None = None
_LOCK = threading.Lock()


def _cpu_flags() -> bytes:
    """The host CPU's feature flags (Linux), which `-march=native` builds for."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            return next((line for line in f if line.startswith(b"flags")), b"")
    except OSError:
        return b""


def library_path() -> str:
    """Where the host AdamW library is (or will be) built: a name hashed from
    the source, the flags and the CPU's features (a build for another CPU
    may not run here), in the port's build directory."""
    digest = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    with open(CSRC, "rb") as f:
        digest.update(f.read())
    digest.update(_cpu_flags())
    return os.path.join(kernel_build.build_dir(), f"host_adamw-{digest.hexdigest()[:16]}.so")


def load_native() -> ctypes.CDLL:
    """The host AdamW library, compiled by g++ on first use. Raises when the
    build or the load fails: there is no fallback."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(path), exist_ok=True)
            tmp = f"{path}.{os.getpid()}.tmp"
            result = subprocess.run(["g++", *GXX_FLAGS, CSRC, "-o", tmp],
                                    capture_output=True, text=True)
            if result.returncode != 0:
                raise RuntimeError(f"g++ failed to build {CSRC} ({result.returncode}):\n"
                                   f"{result.stderr}")
            os.replace(tmp, path)  # atomic: a concurrent process never loads half a file
            logger.info("built the host AdamW library -> %s", path)
        lib = ctypes.CDLL(path)
        ptr, i64, f32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_float
        lib.adamw_step.argtypes = [ptr, ptr, ptr, ptr, i64, f32, f32, f32, f32, f32, i64, f32]
        lib.adamw_step.restype = None
        lib.l2_norm_sq.argtypes = [ptr, i64]
        lib.l2_norm_sq.restype = ctypes.c_double
        lib.f32_to_bf16.argtypes = [ptr, ptr, i64]
        lib.f32_to_bf16.restype = None
        # the OpenMP runtime this library runs on (a dependency of it, so the
        # lookup through its handle finds that runtime's entry points)
        lib.omp_set_num_threads.argtypes = [ctypes.c_int]
        lib.omp_set_num_threads.restype = None
        lib.omp_get_max_threads.argtypes = []
        lib.omp_get_max_threads.restype = ctypes.c_int
        _lib = lib
        return lib


def default_threads() -> int:
    """This process's share of the CPUs it may run on: the affinity divided
    by the processes of the run on this host (LOCAL_WORLD_SIZE, which
    torch.distributed.run sets), so that several ranks do not each start a
    team of every core."""
    local = int(os.environ.get("LOCAL_WORLD_SIZE") or 1)
    return max(1, len(os.sched_getaffinity(0)) // max(local, 1))


def adamw_plain(p: torch.Tensor, m: torch.Tensor, v: torch.Tensor, g: torch.Tensor,
                lr: float, b1: float, b2: float, eps: float, wd: float, step: int,
                grad_scale: float) -> None:
    """The C++ `adamw_step` in PyTorch on CPU fp32 tensors, in place (the JAX
    module's numpy fallback): the update's plain twin."""
    g = g * grad_scale
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    mhat = m / (1 - b1 ** step)
    vhat = v / (1 - b2 ** step)
    p.sub_(lr * (mhat / (vhat.sqrt() + eps) + wd * p))


def _ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


class _Fp32Grad(torch.autograd.Function):
    """A working-copy leaf as the model reads it, whose gradient is added in
    fp32 to a buffer instead of flowing on. `upcast` hands the model an fp32
    copy (for the leaves it reads in fp32: the norms, and the embedding, whose
    gather then backpropagates in fp32 as on the masters); otherwise the leaf
    itself."""

    @staticmethod
    def forward(ctx, token, w, sink, upcast):
        ctx.sink = sink
        return w.float() if upcast else w.view_as(w)

    @staticmethod
    def backward(ctx, grad):
        ctx.sink.add_(grad)  # widened to fp32 as it is read: one kernel, no cast pass
        return None, None, None, None


_TOKEN = torch.zeros((), requires_grad=True)  # makes autograd record _Fp32Grad


def reads_fp32(name: str) -> bool:
    """Whether the model reads this leaf in fp32 (rms_norm's weight; the
    embedding, gathered then cast) rather than cast to the compute dtype."""
    return name.endswith("norm") or name.endswith("embed.embedding")


def bind_fp32_grads(working: Params, grads: Params) -> Params:
    """`working` as a model reads it, each leaf's gradient added to
    `grads[name]` (fp32, same shape) in the backward. The model sees the same
    values as the fp32 masters' cast (fp32 leaves keep their upcast exactly)
    and the same fp32 per-microbatch gradients, added in the same order."""
    return {name: _Fp32Grad.apply(_TOKEN, w, grads[name],
                                  w.dtype != torch.float32 and reads_fp32(name))
            for name, w in working.items()}


class _Staging:
    """Pinned host slots for one direction of the link, reused round robin:
    slot i % SLOTS holds piece i; `ready[k]` is the event of slot k's last copy."""

    def __init__(self, numel: int, dtype: torch.dtype):
        self.slots = [torch.empty(numel, dtype=dtype, pin_memory=True) for _ in range(SLOTS)]
        self.ready: list[torch.cuda.Event | None] = [None] * SLOTS

    def take(self, i: int, numel: int) -> torch.Tensor:
        """The first `numel` elements of slot i % SLOTS, after its previous
        copy completed."""
        k = i % SLOTS
        if self.ready[k] is not None:
            self.ready[k].synchronize()
        return self.slots[k][:numel]

    def copied(self, i: int, stream) -> torch.cuda.Event:
        event = torch.cuda.Event()
        event.record(stream)
        self.ready[i % SLOTS] = event
        return event


@dataclasses.dataclass
class HostOffloadAdamW:
    """Clip + AdamW + schedule (optim/optimizer.AdamW's numerics, which are
    optax's) over fp32 masters and moments in host memory. `init(params)`
    copies the leaves to the host; `device_params` makes the working copy;
    `update_and_refresh(grads, working)` (or `step`, with AdamW.step's
    signature) steps the masters and refreshes the working copy in place;
    `update` steps without refreshing. `last_timings` holds the last step's
    phases in ms, `last_grad_norm` and `last_lr` its norm and learning rate.
    `skip_nonfinite` (the numerics guard, the reference's): a nonfinite
    global norm leaves masters, moments and step count untouched, and the
    working copy is not refreshed (it already holds the masters' cast);
    `last_nonfinite` flags the verdict either way and `nonfinite_count`
    counts the skips. The norm is global (over every process), so every
    process skips the same step, at dp > 1 and in the ZeRO-2 layout too.
    `reduce_norm_sq` adds a host-path norm's square over processes (None:
    this process holds every leaf) and `counts_in_norm` picks the leaves
    this process adds (None: all). `dims` (the ZeRO-2 layout: a dim a leaf,
    None for a whole leaf), `dp`, `index` and `group`: this replica's slices
    (module docstring); the masters and moments are then the slices, while
    the gradients and the working copy stay whole leaves."""

    cfg: OptimizerConfig
    device_norm: bool = False
    skip_nonfinite: bool = False
    threads: int | None = None
    reduce_norm_sq: Callable[[float], float] | None = None
    counts_in_norm: Callable[[str], bool] | None = None
    dims: dict[str, int | None] | None = None
    dp: int = 1
    index: int = 0
    group: Any = None

    def part(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """This replica's slice of a whole leaf `t` (a view; `t` itself
        outside the ZeRO-2 layout or where the leaf is not split)."""
        return dp_part(t, (self.dims or {}).get(name), self.dp, self.index)

    def init(self, params: Params) -> None:
        self._native = load_native()
        self.threads = self.threads or default_threads()
        self.masters: Params = {}
        self.m: Params = {}
        self.v: Params = {}
        for name, t in params.items():  # one leaf at a time: the card frees as it goes
            part = self.part(name, t.detach())
            self.masters[name] = part.to("cpu", torch.float32, copy=True).contiguous()
            self.m[name] = torch.zeros(part.shape, dtype=torch.float32)
            self.v[name] = torch.zeros(part.shape, dtype=torch.float32)
        self.step_count = 0
        self._schedule = warmup_decay_schedule(self.cfg.learning_rate, self.cfg.total_steps,
                                               self.cfg.warmup_steps)
        self.last_timings: dict[str, float] = {}
        self.last_grad_norm = float("nan")
        self.last_lr = float(self._schedule(0))
        self.last_nonfinite = False
        self.nonfinite_count = 0
        self._streams: dict = {}
        self._down: _Staging | None = None
        self._up: dict[torch.dtype, _Staging] = {}
        logger.info("host AdamW: %d leaves, %.3f GB of fp32 masters and moments in host "
                    "memory, %d OpenMP threads (torch intra-op threads: %d)",
                    len(self.masters), 12 * self.numel() / 1e9, self.threads,
                    torch.get_num_threads())

    def numel(self) -> int:
        return sum(t.numel() for t in self.masters.values())

    # -- master access ----------------------------------------------------

    def _check_tree(self, tree, whole: bool = False) -> None:
        """`tree` has the masters' names and shapes (`whole`: whole leaves,
        of which the masters are this replica's slices)."""
        names = set(tree.keys())
        if names != set(self.masters):
            raise ValueError(f"tree does not match the initialized param tree: "
                             f"{sorted(names ^ set(self.masters))} are not in both")
        for name, t in self.masters.items():
            got = self.part(name, tree[name]) if whole else tree[name]
            if tuple(got.shape) != tuple(t.shape):
                raise ValueError(f"tree does not match the initialized param tree: {name} is "
                                 f"{tuple(got.shape)}, initialized {tuple(t.shape)}")

    @torch.no_grad()
    def _load(self, targets: Params, tree) -> None:
        self._check_tree(tree)
        for name, t in targets.items():
            t.copy_(tree[name])

    def load_masters(self, params) -> None:
        """Replace the fp32 masters (warm start, resume) with `params`
        (tensors on any device, named as at init)."""
        self._load(self.masters, params)

    def masters_tree(self) -> Params:
        """The fp32 masters: the live host tensors (the next step updates them
        in place)."""
        return self.masters

    def moments_tree(self, attr: str) -> Params:
        """One moment ("m" or "v"): the live host tensors."""
        if attr not in ("m", "v"):
            raise ValueError(f"moments_tree takes 'm' or 'v', not {attr!r}")
        return getattr(self, attr)

    def state_dict(self) -> dict:
        return {"m": self.m, "v": self.v, "step_count": self.step_count}

    def load_state_dict(self, state: dict) -> None:
        self._load(self.m, state["m"])
        self._load(self.v, state["v"])
        self.step_count = int(state["step_count"])

    # -- the link -----------------------------------------------------------

    def _stream(self, key: str, device: torch.device):
        stream = self._streams.get((key, device))
        if stream is None:
            stream = self._streams[(key, device)] = torch.cuda.Stream(device)
        return stream

    def _pieces(self) -> list[tuple[str, int, int]]:
        """(name, begin, end): each leaf's flat elements in pieces of at most
        PIECE, leaf by leaf in order."""
        return [(name, a, min(a + PIECE, t.numel())) for name, t in self.masters.items()
                for a in range(0, t.numel(), PIECE)]

    def _slot_numel(self) -> int:
        return min(PIECE, max(t.numel() for t in self.masters.values()))

    def _down_staging(self) -> _Staging:
        if self._down is None:
            self._down = _Staging(self._slot_numel(), torch.float32)
        return self._down

    def _up_staging(self, dtype: torch.dtype) -> _Staging:
        if dtype not in self._up:
            self._up[dtype] = _Staging(self._slot_numel(), dtype)
        return self._up[dtype]

    @contextlib.contextmanager
    def _team(self, n: int):
        """The OpenMP threads of the library calls inside, on n elements; the
        process's count (torch's intra-op threads) is restored after."""
        before = self._native.omp_get_max_threads()
        self._native.omp_set_num_threads(max(1, min(self.threads, n // PER_THREAD)))
        try:
            yield
        finally:
            self._native.omp_set_num_threads(before)

    def _cast_into(self, master: torch.Tensor, out: torch.Tensor) -> None:
        """The working-copy value of `master` into the host tensor `out` (both
        flat): bf16 by the library's round to nearest even, other dtypes by
        torch."""
        if out.dtype == torch.bfloat16:
            with self._team(master.numel()):
                self._native.f32_to_bf16(_ptr(master), _ptr(out), master.numel())
        else:
            out.copy_(master)

    def _upload(self, i: int, piece: tuple[str, int, int], out: torch.Tensor, up) -> None:
        """Cast piece i of the masters and copy it into the same elements of
        `out` (the piece's working-copy leaf): on the card through pinned
        slot i % SLOTS on the upload stream, on the CPU in place."""
        name, a, b = piece
        master, dst = self.masters[name].view(-1)[a:b], out.view(-1)[a:b]
        if not out.is_cuda:
            self._cast_into(master, dst)
            return
        staging = self._up_staging(out.dtype)
        slot = staging.take(i, b - a)
        self._cast_into(master, slot)
        with torch.cuda.stream(up):
            dst.copy_(slot, non_blocking=True)
        staging.copied(i, up)

    @torch.no_grad()
    def device_params(self, dtype: torch.dtype = torch.bfloat16,
                      device: str | torch.device = "cuda", out: Params | None = None) -> Params:
        """The working copy: each master cast to `dtype` on the host and
        copied onto `device`, into `out` (same names) when given, else into
        new tensors (`dtype` and `device` then are `out`'s)."""
        t0 = time.perf_counter()
        if out is None:
            out = {name: torch.empty(self._whole_shape(name), dtype=dtype, device=device)
                   for name in self.masters}
        else:
            self._check_tree(out, whole=True)
        device = next(iter(out.values())).device
        up = self._begin(device)
        targets = self._upload_targets(out)
        for i, piece in enumerate(self._pieces()):
            self._upload(i, piece, targets[piece[0]], up)
        self._end(device, up)
        self._gather(out, targets)
        self.last_timings["h2d_ms"] = 1e3 * (time.perf_counter() - t0)
        return out

    def _whole_shape(self, name: str) -> tuple[int, ...]:
        shape = list(self.masters[name].shape)
        dim = (self.dims or {}).get(name)
        if dim is not None:
            shape[dim] *= self.dp
        return tuple(shape)

    def _upload_targets(self, working: Params) -> Params:
        """Where each leaf's stepped slice is uploaded: the working leaf
        itself when it is whole here, else a buffer of the slice beside it
        (gathered into the leaf by `_gather`)."""
        return {name: w if self.part(name, w) is w else
                torch.empty(self.masters[name].shape, dtype=w.dtype, device=w.device)
                for name, w in working.items()}

    def _gather(self, working: Params, targets: Params) -> None:
        """Each split leaf of the working copy from every replica's slice,
        all-gathered over the dp group (after the uploads: `_end`)."""
        for name, w in working.items():
            part = targets[name]
            if part is w:
                continue
            dim = self.dims[name]
            n = part.shape[dim]
            for j, got in enumerate(distributed.all_gather(part, self.group)):
                w.narrow(dim, j * n, n).copy_(got)

    def _begin(self, device: torch.device):
        """The upload stream, ordered after every kernel queued so far on the
        compute stream (the step's reads of the working copy); None off the
        card."""
        if device.type != "cuda":
            return None
        up = self._stream("up", device)
        up.wait_stream(torch.cuda.current_stream(device))
        return up

    def _end(self, device: torch.device, up) -> None:
        """The compute stream waits for the last upload."""
        if up is not None:
            torch.cuda.current_stream(device).wait_stream(up)

    def _grads_down(self, grads: Params, names=None):
        """Yields (i, piece, the piece's host fp32 gradient, flat) piece by
        piece (of the leaves in `names`, default all), each of this
        replica's slice of the leaf: on the card each through pinned slot i %
        SLOTS, the next piece's copy queued on the download stream before
        this one is handed out (a split leaf's slice made contiguous on that
        stream first); on the CPU a view of the gradient itself."""
        for name, g in grads.items():
            if g.dtype != torch.float32:
                raise ValueError(f"{name}: the host AdamW takes fp32 gradients, got {g.dtype}")
        pieces = [p for p in self._pieces() if names is None or p[0] in names]
        first = grads[pieces[0][0]] if pieces else None
        if first is None or not first.is_cuda:
            for i, (name, a, b) in enumerate(pieces):
                g = self.part(name, grads[name].detach())
                yield i, (name, a, b), g.contiguous().view(-1)[a:b]
            return
        device = first.device
        down = self._stream("down", device)
        down.wait_stream(torch.cuda.current_stream(device))
        staging = self._down_staging()
        events = {}
        sources: dict[str, torch.Tensor] = {}

        def fetch(i):
            name, a, b = pieces[i]
            slot = staging.take(i, b - a)
            with torch.cuda.stream(down):
                if name not in sources:  # the leaf's slice, made on (and freed by) this stream
                    sources.clear()
                    sources[name] = self.part(name, grads[name]).contiguous()
                slot.copy_(sources[name].view(-1)[a:b], non_blocking=True)
            events[i] = (slot, staging.copied(i, down))

        fetch(0)
        for i, piece in enumerate(pieces):
            if i + 1 < len(pieces):
                fetch(i + 1)
            slot, event = events.pop(i)
            event.synchronize()
            yield i, piece, slot

    # -- the step ---------------------------------------------------------

    def _clip_and_advance(self, norm: float) -> tuple[float, float]:
        """The clip factor from the global norm, the step count, the lr
        sample (the schedule at the count before the increment). A
        nonfinite norm under `skip_nonfinite` advances nothing (the callers
        then apply nothing: `_skipping`)."""
        self.last_nonfinite = not math.isfinite(norm)
        self.last_grad_norm = norm
        if self._skipping():
            self.nonfinite_count += 1
            self.last_lr = float(self._schedule(self.step_count))
            logger.warning("nonfinite global grad norm (%r); skipping the optimizer step "
                           "(%d skipped so far)", norm, self.nonfinite_count)
            return self.last_lr, 0.0
        clip = self.cfg.max_grad_norm
        grad_scale = clip / norm if (clip and norm > clip) else 1.0
        self.step_count += 1
        lr = float(self._schedule(self.step_count - 1))
        self.last_lr = lr
        return lr, grad_scale

    def _skipping(self) -> bool:
        return self.skip_nonfinite and self.last_nonfinite

    def _host_norm(self, grads: Params) -> float:
        """The fp64 global norm of `grads`, streamed down once, piece by piece
        in order (added over processes by `reduce_norm_sq`)."""
        names = None if self.counts_in_norm is None else {
            name for name in self.masters if self.counts_in_norm(name)}
        norm_sq = 0.0
        for _, _, g in self._grads_down(grads, names):
            with self._team(g.numel()):
                norm_sq += self._native.l2_norm_sq(_ptr(g), g.numel())
        if self.reduce_norm_sq is not None:
            norm_sq = self.reduce_norm_sq(norm_sq)
        return math.sqrt(norm_sq)

    def _apply(self, piece: tuple[str, int, int], g: torch.Tensor, lr: float,
               grad_scale: float) -> None:
        cfg = self.cfg
        name, a, b = piece
        p, m, v = (t[name].view(-1)[a:b] for t in (self.masters, self.m, self.v))
        with self._team(b - a):
            self._native.adamw_step(_ptr(p), _ptr(m), _ptr(v), _ptr(g), b - a, lr, cfg.beta1,
                                    cfg.beta2, cfg.eps, cfg.weight_decay, self.step_count,
                                    grad_scale)

    def update(self, grads: Params) -> None:
        """One clipped AdamW step of every master (host-path norm), without
        refreshing a working copy."""
        self._check_tree(grads, whole=True)
        t0 = time.perf_counter()
        lr, grad_scale = self._clip_and_advance(self._host_norm(grads))
        t1 = time.perf_counter()
        if not self._skipping():
            for _, piece, g in self._grads_down(grads):
                self._apply(piece, g, lr, grad_scale)
        self.last_timings = {"d2h_norm_ms": 1e3 * (t1 - t0),
                             "update_ms": 1e3 * (time.perf_counter() - t1)}

    @torch.no_grad()
    def update_and_refresh(self, grads: Params, working: Params,
                           norm: torch.Tensor | float | None = None) -> Params:
        """One clipped AdamW step and the refreshed working copy, streamed per
        leaf (module docstring): each gradient comes down, its master is
        stepped, cast and uploaded into `working[name]` in place while the
        next leaf is in flight. With `device_norm` the clip factor comes from
        `norm` (the global norm of `grads` on the card; computed here when
        None) and phases read `norm_ms` / `stream_d2h_update_h2d_ms`;
        otherwise from the host fp64 norm, `d2h_norm_ms` / `update_h2d_ms`.
        Returns `working`."""
        self._check_tree(grads, whole=True)
        self._check_tree(working, whole=True)
        t0 = time.perf_counter()
        if self.device_norm:
            if norm is None:
                norm = global_norm(grads.values())
            norm = float(norm)
        else:
            norm = self._host_norm(grads)
        lr, grad_scale = self._clip_and_advance(norm)
        t1 = time.perf_counter()
        if not self._skipping():
            device = next(iter(working.values())).device
            up = self._begin(device)
            targets = self._upload_targets(working)
            for i, piece, g in self._grads_down(grads):
                self._apply(piece, g, lr, grad_scale)
                self._upload(i, piece, targets[piece[0]], up)
            self._end(device, up)
            self._gather(working, targets)
        t2 = time.perf_counter()
        phases = (("norm_ms", "stream_d2h_update_h2d_ms") if self.device_norm
                  else ("d2h_norm_ms", "update_h2d_ms"))
        self.last_timings = {phases[0]: 1e3 * (t1 - t0), phases[1]: 1e3 * (t2 - t1)}
        return working

    def step(self, params: Params, grads: Params, norm: torch.Tensor | None = None) -> float:
        """AdamW.step's signature over a working copy `params`: the update,
        the refresh of `params` in place; returns the learning rate used."""
        self.update_and_refresh(grads, params, norm)
        return self.last_lr
