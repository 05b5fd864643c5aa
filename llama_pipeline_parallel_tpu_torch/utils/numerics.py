"""Numerics observatory: per-stage training-dynamics telemetry.

The counterpart of llama_pipeline_parallel_tpu/utils/numerics.py, with its
record format (`numerics.jsonl`, `numerics-snapshot-<step>.json`), its
config block and its counters. Three cooperating pieces:

- **On-card statistics** (`step_stats`, plus the activation stats the
  pipeline folds per stage and chunk — parallel/pipeline.py, and the one
  stage of parallel/train_step.py at pp = 1): norm / absmax / rms
  reductions of the port's parameter layout, which names each leaf either
  canonically (`layers.attn.wq`, a leading axis of the model's layers: pp =
  1) or by its pipeline chunk (`s{stage}c{chunk}/layers.attn.wq`, the
  chunk's layers). Per-stage sums of squares come from
  `torch._foreach_norm`, the absmax of every layer row from one `aminmax`
  per leaf (no |x| temporary), so the cost is a few launches a leaf. Under
  several processes the stats are reduced to the global record the
  reference writes (one SUM and one MAX all-reduce of two small vectors over
  every process): sums of squares add over the tp slices of a split leaf
  and over the stages (a tp-replicated leaf, a dp replica and an sp peer
  count once), absmax takes the max, and the activation sums add over dp
  and sp.
- **Nonfinite guard** (parallel/train_step.py): when any gradient element
  is nonfinite, the step keeps its params and AdamW moments and still
  advances its step counter; the host optimizer (optim/offload.py,
  `skip_nonfinite`) skips from its global norm and advances nothing.
  `halt_on_nonfinite` escalates a skip to a `NonfiniteHaltError` that the
  trainer turns into a final checkpoint + nonzero exit.
- **Host-side anomaly detection** (`AnomalyDetector`, `NumericsMonitor`):
  rolling-window z-scores on loss and global grad norm; one record a step
  to `<output_dir>/numerics.jsonl` (process 0), a `numerics_anomaly` span
  and a per-layer snapshot on an anomaly; counters (`nonfinite_steps`,
  `anomaly_count`) on the metrics line and in health.json. The monitor
  reads a step's stats one step late: `observe` packs them into one flat
  vector, starts its copy into pinned host memory (`non_blocking`) and
  records an event; the previous step's entry is read after its event.

`tools/numerics_report.py` renders the offline view.
"""

from __future__ import annotations

import collections
import dataclasses
import json
import math
import os
import re
import time
from typing import Any

from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

# stats fields whose per-step jsonl record keeps the full per-stage vector;
# everything else is snapshot-only detail. The *_per_chunk fields
# ([num_stages, virtual_stages] nested lists) exist only under the
# interleaved, zb1 and solver schedules, where each stage's activations are
# resolved per virtual chunk (parallel/pipeline.py).
PER_STAGE_FIELDS = ("grad_norm_per_stage", "param_norm_per_stage",
                    "update_norm_per_stage", "act_rms_per_stage",
                    "act_absmax_per_stage", "act_rms_per_chunk",
                    "act_absmax_per_chunk")

# the leaves outside the stage-stacked layers: their groups in the record
REPLICATED_GROUPS = {"embed": "embed.embedding", "norm": "norm", "lm_head": "lm_head"}
LAYER_PREFIX = "layers."
CHUNKED_SCHEDULES = ("interleaved_1f1b", "zb1", "solver")
_CELL = re.compile(r"s(\d+)c(\d+)/(.+)")


class NonfiniteHaltError(RuntimeError):
    """Raised by the monitor when `halt_on_nonfinite` is set and a step's
    gradients were nonfinite. Carries the step so the trainer can cut a
    final checkpoint (the update was skipped, so the saved state is the
    last finite one) before exiting nonzero."""

    def __init__(self, step: int, detail: str = ""):
        super().__init__(
            f"nonfinite gradients at step {step}{': ' + detail if detail else ''}"
            f" — halting (numerics.halt_on_nonfinite)")
        self.step = step


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """The `numerics.*` config node."""

    enabled: bool = True
    # rolling z-score detector: window of recent finite samples, threshold,
    # and the minimum history before any z-score verdict is trusted (early
    # training is legitimately volatile)
    window: int = 50
    zscore: float = 6.0
    min_history: int = 8
    # escalate a nonfinite-grad skip to checkpoint-and-exit-nonzero
    halt_on_nonfinite: bool = False
    # dump the per-layer snapshot json on every anomaly
    snapshot_on_anomaly: bool = True

    @classmethod
    def from_cfg(cls, node: dict | None) -> "NumericsConfig":
        node = dict(node or {})
        unknown = set(node) - {f.name for f in dataclasses.fields(cls)}
        if unknown:
            raise ValueError(f"unknown numerics config keys {sorted(unknown)}; "
                             f"known: {sorted(f.name for f in dataclasses.fields(cls))}")
        return cls(**node)


# ---------------------------------------------------------------------------
# On-card statistics
# ---------------------------------------------------------------------------

def cell(name: str) -> tuple[int, int, str]:
    """(stage, chunk, leaf name) of a leaf named by its chunk
    (`s{stage}c{chunk}/{leaf}`) or canonically (stage 0, chunk 0)."""
    m = _CELL.fullmatch(name)
    if m is None:
        return 0, 0, name
    return int(m.group(1)), int(m.group(2)), m.group(3)


def _row_absmax(g):
    """[rows] abs-max of each leading-axis row of `g`, without an |g|
    temporary (max(|x|) = max(max x, -min x); NaN propagates)."""
    import torch

    lo, hi = torch.aminmax(g.reshape(g.shape[0], -1), dim=1)
    return torch.maximum(hi, -lo).float()


def _sumsq(tensors: list) -> list:
    """fp32 sum of squares of each tensor (torch._foreach_norm, upcast)."""
    import torch

    if not tensors:
        return []
    return [n.square() for n in torch._foreach_norm(tensors, 2, dtype=torch.float32)]


def _counted(name: str, mesh: Any, over_dp: bool) -> bool:
    """Whether this process adds leaf `name` to a global sum of squares: a
    tp-split leaf's slice on every tp rank, a replicated one on tp rank 0;
    on sp rank 0 only (sp peers hold the same), and (`over_dp`) on replica
    0 only (replicas hold the same)."""
    from llama_pipeline_parallel_tpu_torch.parallel.tp import TP_DIMS

    if mesh is None or mesh.process_count == 1:
        return True
    split = cell(name)[2] in TP_DIMS
    return ((split or mesh.tp_rank == 0) and mesh.sp_rank == 0
            and (mesh.replica == 0 or not over_dp))


def _per_stage(names: list, values: list, s_total: int, device: Any):
    """[S] sums of `values` by each name's stage."""
    import torch

    out = torch.zeros(s_total, device=device)
    for name, val in zip(names, values):
        s = cell(name)[0]
        out[s] += val
    return out


def _all_reduce_world(t, mesh: Any, op: str = "sum"):
    """`t` reduced over every process in place (nothing alone)."""
    if mesh is None or mesh.process_count == 1:
        return t
    import torch.distributed as dist

    from llama_pipeline_parallel_tpu_torch.parallel import distributed

    return distributed.all_reduce(t, dist.group.WORLD,
                                  op=dist.ReduceOp.MAX if op == "max" else dist.ReduceOp.SUM)


def update_norms(update_sq: dict, manifest: Any, device: Any, mesh: Any = None):
    """[S] norms of each stage's layer updates from the optimizer's
    per-leaf sums of squares (`AdamW.step(update_sq=...)`, which holds only
    the leaves, or ZeRO-1 slices, whose update it owns), global over
    `mesh`'s processes."""
    names = [n for n in update_sq if cell(n)[2].startswith(LAYER_PREFIX)
             and _counted(n, mesh, over_dp=False)]
    vec = _per_stage(names, [update_sq[n] for n in names], manifest.num_stages, device)
    return _all_reduce_world(vec, mesh).sqrt()


def step_stats(params: dict, grads: dict, manifest: Any, *, act: dict | None = None,
               act_chunked: bool = False, mesh: Any = None) -> dict:
    """Per-stage / per-layer-group statistics of one step, on the card.

    `params` / `grads` are named as the optimizer names them (canonical at
    pp = 1, `s{stage}c{chunk}/...` under a pipeline); `manifest` gives the
    stages, chunks and layers a chunk holds. Layer slots are chunk-major
    (slot j of a stage is chunk j // k, layer j % k, k the most layers a
    chunk holds; an uneven partition's missing rows read 0, as the
    reference's zero padding). `act` ({(stage, chunk): [absmax, mean-square
    sum, count]}, the pipeline's) adds the activation stats, per chunk too
    when `act_chunked`. `mesh` (parallel/mesh.Mesh) makes the record global
    across processes. Returns {field: tensor} with the reference's keys: [S]
    vectors, an [S, slots] grid, per-group [S] vectors, replicated-group
    scalars and `nonfinite` (the update norms come after the update:
    `update_norms`)."""
    import torch

    s_total, v = manifest.num_stages, manifest.virtual_stages
    k_max = max(len(manifest.layers_of_chunk(s, c)) for s in range(s_total)
                for c in range(v))
    device = next(iter(grads.values())).device
    several = mesh is not None and mesh.process_count > 1
    tp_rank = mesh.tp_rank if several else 0
    layers = [n for n in grads if cell(n)[2].startswith(LAYER_PREFIX)]
    groups = sorted({cell(n)[2][len(LAYER_PREFIX):] for n in layers})
    summed = {}
    for key, tree in (("grad", grads), ("param", params)):
        names = [n for n in layers if _counted(n, mesh, over_dp=True)]
        summed[key] = _per_stage(names, _sumsq([tree[n].detach() for n in names]), s_total,
                                 device)

    # abs-max: one row vector a layer leaf; groups and slots are maxima of it
    rows = {n: _row_absmax(grads[n].detach()) for n in layers}
    group_max = torch.zeros((len(groups), s_total), device=device)
    grid = torch.zeros((s_total, v * k_max), device=device)
    for n, r in rows.items():
        s, c, leaf = cell(n)
        g = groups.index(leaf[len(LAYER_PREFIX):])
        group_max[g, s] = torch.maximum(group_max[g, s], r.max())
        span = grid[s, c * k_max:c * k_max + r.shape[0]]
        span.copy_(torch.maximum(span, r))
    replicated = torch.zeros(len(REPLICATED_GROUPS), device=device)
    for i, leaf in enumerate(REPLICATED_GROUPS.values()):
        for n in grads:
            if cell(n)[2] == leaf:
                g = grads[n].detach()
                lo, hi = torch.aminmax(g.reshape(-1))
                replicated[i] = torch.maximum(replicated[i], torch.maximum(hi, -lo).float())
    nonfinite = (~torch.isfinite(torch.cat([group_max.reshape(-1), replicated]))).any().float()

    act_max = torch.zeros((s_total, v), device=device)
    act_msq = torch.zeros((s_total, v), device=device)
    act_n = torch.zeros((s_total, v), device=device)
    for (s, c), (a_max, a_msq, a_n) in (act or {}).items():
        act_max[s, c] = a_max
        if tp_rank == 0:
            act_msq[s, c] = a_msq
            act_n[s, c] = a_n

    sum_parts = [summed["grad"], summed["param"]]
    sum_vec = torch.cat(sum_parts + [act_msq.reshape(-1), act_n.reshape(-1)])
    max_vec = torch.cat([group_max.reshape(-1), grid.reshape(-1), replicated,
                         act_max.reshape(-1), nonfinite.reshape(1)])
    if several:
        # NaN through a MAX all-reduce is not defined: spell it as inf there
        max_vec = torch.nan_to_num(max_vec, nan=math.inf)
        _all_reduce_world(sum_vec, mesh)
        _all_reduce_world(max_vec, mesh, op="max")

    sums = sum_vec.split([s_total] * len(sum_parts) + [s_total * v] * 2)
    parts = max_vec.split([len(groups) * s_total, s_total * v * k_max, len(REPLICATED_GROUPS),
                           s_total * v, 1])
    group_max = parts[0].reshape(len(groups), s_total)
    stats = {
        "grad_norm_per_stage": sums[0].sqrt(),
        "param_norm_per_stage": sums[1].sqrt(),
        "grad_absmax_per_group": {g: group_max[i] for i, g in enumerate(groups)},
        "grad_absmax_per_layer": parts[1].reshape(s_total, v * k_max),
        "replicated_groups": dict(zip(REPLICATED_GROUPS, parts[2])),
        "nonfinite": parts[4][0] > 0,
    }
    if act is not None:
        a_max = parts[3].reshape(s_total, v)
        a_msq, a_n = sums[-2].reshape(s_total, v), sums[-1].reshape(s_total, v)
        stats["act_absmax_per_stage"] = a_max.amax(dim=1)
        stats["act_rms_per_stage"] = (a_msq.sum(1) / a_n.sum(1).clamp(min=1.0)).sqrt()
        if act_chunked:
            stats["act_absmax_per_chunk"] = a_max
            stats["act_rms_per_chunk"] = (a_msq / a_n.clamp(min=1.0)).sqrt()
    return stats


def act_fold(acc: dict, key: tuple[int, int], y) -> None:
    """Fold one unit's stage-boundary activation `y` (a chunk's output
    before any final norm) into `acc[key]` = [absmax, mean-square sum,
    count] (the reference's `_act_stat_update`: the max of |y|, the sum of
    each unit's mean of y^2, the units folded)."""
    import torch

    y = y.detach()
    lo, hi = torch.aminmax(y.reshape(-1))
    absmax = torch.maximum(hi, -lo).float()
    msq = torch.linalg.vector_norm(y, dtype=torch.float32).square() / y.numel()
    prev = acc.get(key)
    if prev is None:
        acc[key] = [absmax, msq, 1.0]
    else:
        acc[key] = [torch.maximum(prev[0], absmax), prev[1] + msq, prev[2] + 1.0]


def poison_grads(grads: dict, stage: int) -> dict:
    """Scale the layer gradients of pipeline stage `stage` by +inf in place
    (zeros become NaN via inf * 0 — still nonfinite, which is the point):
    the `grad_nonfinite` fault op's failure, born in one stage at a chosen
    step. Other leaves and stages are untouched; -1 poisons nothing."""
    if stage < 0:
        return grads
    for name, g in grads.items():
        s, _, leaf = cell(name)
        if s == stage and leaf.startswith(LAYER_PREFIX):
            g.mul_(math.inf)
    return grads


def fault_stage(verdict: str | None) -> int:
    """Parse a faults.fire() step-site verdict into the stage to poison
    (-1 = no poison this step)."""
    if verdict and verdict.startswith("grad_nonfinite"):
        _, _, stage = verdict.partition(":")
        return int(stage or 0)
    return -1


# ---------------------------------------------------------------------------
# Host-side anomaly detection
# ---------------------------------------------------------------------------

class AnomalyDetector:
    """Rolling-window z-score on one scalar series.

    `push(x)` returns the z-score of x against the PREVIOUS window when the
    detector has enough history, else None; the sample then joins the window
    only if finite (a NaN loss must not poison the baseline that flags the
    next spike). Degenerate windows (near-zero std early in training when
    the series is flat) are floored so a microscopic wiggle is not a
    6-sigma event."""

    def __init__(self, window: int, min_history: int):
        self._buf: collections.deque = collections.deque(maxlen=max(window, 2))
        self._min = max(min_history, 2)

    def push(self, x: float) -> float | None:
        z = None
        if math.isfinite(x) and len(self._buf) >= self._min:
            n = len(self._buf)
            mean = sum(self._buf) / n
            var = sum((v - mean) ** 2 for v in self._buf) / n
            std = max(math.sqrt(var), 1e-6 * max(abs(mean), 1.0), 1e-12)
            z = (x - mean) / std
        if math.isfinite(x):
            self._buf.append(x)
        return z


def _to_py(x: Any) -> Any:
    """numpy / tensor -> plain python (lists/floats/bools) for json.
    Nonfinite floats become the strings json.dumps would reject."""
    import numpy as np

    arr = np.asarray(x)
    if arr.ndim == 0:
        v = arr.item()
        if isinstance(v, float) and not math.isfinite(v):
            return "inf" if v > 0 else ("-inf" if v < 0 else "nan")
        return v
    return [_to_py(v) for v in arr]


def _flatten(tree: Any, prefix: tuple = ()) -> list[tuple[tuple, Any]]:
    if isinstance(tree, dict):
        return [item for k in tree for item in _flatten(tree[k], prefix + (k,))]
    return [(prefix, tree)]


class _Fetch:
    """One step's values on their way to the host: every tensor leaf packed
    into one fp32 vector, copied into pinned memory without blocking, with
    an event after the copy (on the CPU: the values themselves)."""

    def __init__(self, tree: dict):
        import torch

        leaves = _flatten(tree)
        self._spec = [(path, None if not torch.is_tensor(x) else (tuple(x.shape), x.dtype))
                      for path, x in leaves]
        self._plain = {path: x for path, x in leaves if not torch.is_tensor(x)}
        tensors = [x.detach().reshape(-1).float() for _, x in leaves if torch.is_tensor(x)]
        self._event = None
        if not tensors:
            self._flat = None
            return
        flat = torch.cat(tensors)
        if flat.is_cuda:
            host = torch.empty(flat.shape, dtype=flat.dtype, pin_memory=True)
            host.copy_(flat, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record()
            flat = host
        self._flat = flat

    def get(self) -> dict:
        """The tree as numpy values (bools where the leaf was bool)."""
        import numpy as np

        if self._event is not None:
            self._event.synchronize()
        flat = None if self._flat is None else self._flat.numpy()
        out: dict = {}
        i = 0
        for path, spec in self._spec:
            if spec is None:
                val = self._plain[path]
            else:
                shape, dtype = spec
                n = int(np.prod(shape)) if shape else 1
                val = flat[i:i + n].reshape(shape)
                i += n
                if str(dtype) == "torch.bool":
                    val = val.astype(bool)
            node = out
            for k in path[:-1]:
                node = node.setdefault(k, {})
            node[path[-1]] = val
        return out


class NumericsMonitor:
    """The host half of the observatory: deferred stat fetch, per-step
    numerics.jsonl records, anomaly spans/snapshots, nonfinite accounting.

    `observe(step, loss, grad_norm, stats)` starts the step's copy to the
    host (`_Fetch`) and then processes the PREVIOUS step's entry — whose
    copy has long landed — so the loop never waits on the current step's
    values. `flush()` drains the last pending entry at loop exit.

    Every process runs a monitor (the stats are global, so detection — and
    a `halt_on_nonfinite` raise — happens on every process at the same
    step); only `write=True` (process 0) persists jsonl/snapshots.
    `health_fields` is a live dict handed to the Heartbeat as `extra`, so
    health.json always carries the current counters.
    """

    def __init__(self, output_dir: str, cfg: NumericsConfig,
                 write: bool = True, recorder: Any = None):
        self.cfg = cfg
        self._dir = output_dir
        self._recorder = recorder
        self._f = None
        if write:
            os.makedirs(output_dir, exist_ok=True)
            self._f = open(os.path.join(output_dir, "numerics.jsonl"), "a",
                           buffering=1)
        self._pending: collections.deque = collections.deque()
        self._loss_det = AnomalyDetector(cfg.window, cfg.min_history)
        self._grad_det = AnomalyDetector(cfg.window, cfg.min_history)
        self.nonfinite_steps = 0
        self.anomaly_count = 0
        self.health_fields: dict[str, Any] = {
            "nonfinite_steps": 0, "anomaly_count": 0, "grad_norm": None}

    # -- the per-step path -------------------------------------------------

    def observe(self, step: int, loss: Any, grad_norm: Any,
                stats: dict | None) -> None:
        """Start this step's copy to the host and process the previous
        step's. May raise NonfiniteHaltError (from the PREVIOUS step's
        record) when halt_on_nonfinite is configured."""
        tree = {"loss": loss, "grad_norm": grad_norm}
        if stats is not None:
            tree["stats"] = stats
        self._pending.append((step, _Fetch(tree)))
        while len(self._pending) > 1:
            self._process(self._pending.popleft())

    def flush(self) -> None:
        """Drain pending entries (end of loop / before a final save). Raises
        like observe()."""
        while self._pending:
            self._process(self._pending.popleft())

    def close(self) -> None:
        if self._f is not None:
            self._f.close()
            self._f = None

    def scalars(self) -> dict[str, Any]:
        """Counters for the metrics line."""
        return {"nonfinite_steps": self.nonfinite_steps,
                "anomaly_count": self.anomaly_count}

    # -- record construction ----------------------------------------------

    def _process(self, entry: tuple) -> None:
        step, fetch = entry
        values = fetch.get()
        stats = values.get("stats")
        loss = float(values["loss"])
        grad_norm = values["grad_norm"]
        grad_norm = None if grad_norm is None else float(grad_norm)
        rec: dict[str, Any] = {"step": step, "ts": time.time(),
                               "loss": _finite_or_str(loss),
                               "grad_norm": _finite_or_str(grad_norm)}
        nonfinite = False
        if stats is not None:
            host_stats = {k: _to_py(v) for k, v in stats.items()
                          if k not in ("grad_absmax_per_group",
                                       "grad_absmax_per_layer",
                                       "replicated_groups")}
            nonfinite = bool(host_stats.pop("nonfinite", False))
            for key in PER_STAGE_FIELDS:
                if key in host_stats:
                    rec[key] = host_stats[key]
            if ("update_norm_per_stage" in rec
                    and "param_norm_per_stage" in rec):
                rec["update_ratio_per_stage"] = [
                    _finite_or_str(u / p if p else 0.0)
                    for u, p in zip(
                        [stat_to_float(v) for v in rec["update_norm_per_stage"]],
                        [stat_to_float(v) for v in rec["param_norm_per_stage"]])]
        if grad_norm is not None and not math.isfinite(grad_norm):
            nonfinite = True
        rec["nonfinite"] = nonfinite

        z_loss = self._loss_det.push(loss)
        z_grad = (self._grad_det.push(grad_norm)
                  if grad_norm is not None else None)
        kinds = []
        if nonfinite:
            kinds.append("nonfinite")
        if z_loss is not None and abs(z_loss) > self.cfg.zscore:
            kinds.append("loss_spike")
        if z_grad is not None and abs(z_grad) > self.cfg.zscore:
            kinds.append("grad_spike")
        if z_loss is not None:
            rec["z_loss"] = round(z_loss, 3)
        if z_grad is not None:
            rec["z_grad"] = round(z_grad, 3)
        if kinds:
            rec["anomaly"] = kinds
            self.anomaly_count += 1
        if nonfinite:
            self.nonfinite_steps += 1
        self.health_fields.update(nonfinite_steps=self.nonfinite_steps,
                                  anomaly_count=self.anomaly_count,
                                  grad_norm=_finite_or_str(grad_norm))

        if self._f is not None:
            self._f.write(json.dumps(rec) + "\n")
        if kinds:
            self._on_anomaly(step, rec, stats, kinds)
        if nonfinite and self.cfg.halt_on_nonfinite:
            raise NonfiniteHaltError(step, detail=",".join(kinds))

    def _on_anomaly(self, step: int, rec: dict, stats: dict | None,
                    kinds: list) -> None:
        logger.warning("numerics anomaly at step %d: %s (z_loss=%s z_grad=%s)",
                       step, ",".join(kinds), rec.get("z_loss"),
                       rec.get("z_grad"))
        if self._recorder is not None:
            # zero-duration marker span into the trace stream: the anomaly
            # lines up against data_wait/device_step on the same timeline
            # (not a SPAN_BUCKETS name, so goodput is untouched)
            self._recorder.emit("numerics_anomaly", time.time(), 0.0,
                                step=step, kinds=kinds)
        if self._f is not None and self.cfg.snapshot_on_anomaly and stats:
            snap = {"step": step, "kinds": kinds, "record": rec,
                    "grad_absmax_per_group":
                        {k: _to_py(v) for k, v in
                         stats.get("grad_absmax_per_group", {}).items()},
                    "grad_absmax_per_layer":
                        _to_py(stats["grad_absmax_per_layer"])
                        if "grad_absmax_per_layer" in stats else None,
                    "replicated_groups":
                        {k: _to_py(v) for k, v in
                         stats.get("replicated_groups", {}).items()}}
            path = os.path.join(self._dir, f"numerics-snapshot-{step}.json")
            try:
                with open(path, "w") as f:
                    json.dump(snap, f, indent=2)
            except OSError:  # a full disk must not kill training
                logger.exception("could not write numerics snapshot %s", path)


def stat_to_float(v: Any) -> float:
    """Decode one numerics.jsonl stat value: the writer spells nonfinite
    floats as 'inf'/'-inf'/'nan' (JSON has no representation for them —
    see _finite_or_str, the one encode site this must mirror). The offline
    tools (tools/numerics_report.py) share this decoder."""
    if isinstance(v, str):
        return {"inf": math.inf, "-inf": -math.inf}.get(v, math.nan)
    return float(v)


def _finite_or_str(v: float | None) -> Any:
    if v is None:
        return None
    if isinstance(v, str) or math.isfinite(v):
        return v
    return "inf" if v > 0 else ("-inf" if v < 0 else "nan")
