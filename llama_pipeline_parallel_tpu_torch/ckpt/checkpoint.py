"""Checkpoint save/load/resume over safetensors files.

The counterpart of llama_pipeline_parallel_tpu/ckpt/checkpoint.py, keeping
its `meta.json` contract, its methods and their semantics; the arrays are
stored in the safetensors layout (ckpt/tensor_io.py) instead of Orbax's:

    <root>/checkpoint-<step>/params.safetensors   parameters by dotted name,
                                                  layer leaves [num_layers, ...]
    <root>/checkpoint-<step>/opt.safetensors      `mu.<name>`, `nu.<name>`,
                                                  `count` (full-state saves only)
    <root>/checkpoint-<step>/opt_m.safetensors    instead of opt.safetensors under the
    <root>/checkpoint-<step>/opt_v.safetensors    host optimizer (a ShardedState of its
                                                  `offload` layout): the moments by
                                                  name, canonical
    <root>/checkpoint-<step>/meta.json            written last: its presence marks
                                                  a complete checkpoint
    <root>/latest                                 tag naming the newest one

`meta.json` holds the reference's keys with the reference's values (`step`,
`manifest`, `model_config`, `format_version`, `has_optimizer_state`,
`integrity`, and the trainer's `topology` and `data_state`) plus `"storage":
"safetensors"`; a host optimizer's checkpoint adds the reference's
`"opt_layout": "offload_parts"` and `opt_step_count`. Each layout is
resumed only by its own optimizer (both refusals name the remedy); either
warm-starts the weights (`load_params`). A checkpoint whose meta.json lacks
`storage` was written by the JAX package (Orbax arrays) and is refused by
name: the route between the two packages is the HF format (each package's
export_hf and convert_hf).

Integrity: the commit records each file's sha256 in meta.json; restores
verify them first and QUARANTINE a corrupt checkpoint to
`checkpoint-N.corrupt` (latest_step() then falls back to the previous
complete one). meta/tag writes are atomic (tmp + fsync + os.replace), and all
storage I/O runs under the shared transient-retry policy (utils/retry.py,
LPT_RETRY_* knobs). Each try of a file write or read fires the
`storage_write` fault site, and the commit fires `ckpt_commit` before its
digests and meta/tag writes (utils/faults.py, where the JAX package fires
them). `LPT_CKPT_DIGESTS=0` skips the digests at commit,
`LPT_CKPT_VERIFY=0` the verification at restore.

A run of several processes (parallel/distributed.py) commits as the
reference's `_commit` does: the tensors are durable before a barrier of
every process, the `ckpt_commit` fault site fires after it, process 0 alone
writes the digests, meta.json and the tag, and a second barrier ends the
commit; an async save stays async (the barriers are on a gloo group of
their own, so the commit thread waits there while the main thread trains).
The trainer passes its state as a ckpt/gather.ShardedState, in one process
or several, of either optimizer: process 0 writes the files a one-process
run reads, one canonical leaf at a time, from the pieces every process holds
(its own, or sent on request by the process that holds them), while the
other processes serve those requests. Prune runs on process 0 only.

Spans (utils/trace.py, the reference's names): `ckpt_save` around a save as
the caller pays for it, `ckpt_commit` around an async commit on its thread,
`ckpt_digest` around the commit's digests, `ckpt_verify` around a
verification, and `ckpt_restore` (item params, opt or offload_moments)
around each restored file.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import hashlib
import json
import os
import re
import shutil
import threading
import time
from typing import Any

import torch

from llama_pipeline_parallel_tpu_torch.ckpt import gather, tensor_io
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
from llama_pipeline_parallel_tpu_torch.models.llama.model import param_shapes
from llama_pipeline_parallel_tpu_torch.parallel import distributed
from llama_pipeline_parallel_tpu_torch.utils import faults, retry, trace
from llama_pipeline_parallel_tpu_torch.utils.logging import get_logger

logger = get_logger(__name__)

LATEST_TAG = "latest"
_CKPT_RE = re.compile(r"^checkpoint-(\d+)$")
QUARANTINE_SUFFIX = ".corrupt"
PARAMS_FILE = "params.safetensors"
OPT_FILE = "opt.safetensors"
# the host optimizer's layout: the masters, then each moment, one file each
OFFLOAD_LAYOUT = "offload_parts"
OPT_M_FILE = "opt_m.safetensors"
OPT_V_FILE = "opt_v.safetensors"
STORAGE = "safetensors"
# a ShardedState's file roles (ckpt/gather.ShardedState.files)
_FILES = {"params": PARAMS_FILE, "opt": OPT_FILE, "opt_m": OPT_M_FILE, "opt_v": OPT_V_FILE}
HF_ROUTE = ("export it to HF with the JAX package's tools/export_hf.py, then convert "
            "that directory with python -m llama_pipeline_parallel_tpu_torch.tools.convert_hf")


class CheckpointCorruptError(RuntimeError):
    """A checkpoint failed integrity verification (or its meta.json is
    unreadable). Deliberately NOT an OSError: the retry layer must never
    re-try a deterministic corruption verdict -- the caller falls back to
    the previous complete checkpoint instead."""


def _storage_policy() -> retry.RetryPolicy:
    """The shared transient-storage retry policy (env-tunable, LPT_RETRY_*)."""
    return retry.RetryPolicy.from_env()


def _write_file_atomic(path: str, data: str) -> None:
    """A small text file written crash-safe (tensor_io.write_atomic)."""
    tensor_io.write_atomic(path, lambda f: f.write(data.encode()))


def _digests_enabled() -> bool:
    return os.environ.get("LPT_CKPT_DIGESTS", "1") != "0"


def _verify_default() -> bool:
    return os.environ.get("LPT_CKPT_VERIFY", "1") != "0"


def _file_digest(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _digests(files: dict[str, str]) -> dict[str, str]:
    """sha256 of each file of {relative name: path}, each under the storage
    retry policy, the files hashed at once on threads of their own (hashlib
    releases the GIL, so a checkpoint's files take the time of its largest)."""
    def one(item):
        rel, full = item
        return rel, retry.retry_call(lambda: _file_digest(full), policy=_storage_policy(),
                                     describe=f"digest {rel}")

    if len(files) < 2:
        return dict(map(one, files.items()))
    with concurrent.futures.ThreadPoolExecutor(max_workers=min(len(files), 8)) as pool:
        return dict(pool.map(one, files.items()))


def _dir_digests(root: str) -> dict[str, str]:
    """sha256 of every file under `root` (relative posix paths), meta.json
    excluded -- the digests live INSIDE meta.json, which is written after
    this walk, so it can never hash itself."""
    files: dict[str, str] = {}
    for dirpath, _dirnames, filenames in os.walk(root):
        for name in sorted(filenames):
            full = os.path.join(dirpath, name)
            rel = os.path.relpath(full, root).replace(os.sep, "/")
            if rel != "meta.json":
                files[rel] = full
    return _digests(files)


def _config_meta(cfg: LlamaConfig) -> dict:
    """The config as meta.json records it: dtypes by their numpy names."""
    out = {}
    for k, v in dataclasses.asdict(cfg).items():
        if k in ("dtype", "param_dtype"):
            out[k] = v if isinstance(v, str) else str(v).removeprefix("torch.")
        else:
            out[k] = v
    return out


def _optimizer_tensors(optimizer: Any) -> dict[str, torch.Tensor]:
    """AdamW.state_dict() as the flat names of opt.safetensors."""
    sd = optimizer.state_dict()
    out = {f"mu.{k}": v for k, v in sd["mu"].items()}
    out.update({f"nu.{k}": v for k, v in sd["nu"].items()})
    out["count"] = torch.tensor(int(sd["count"]), dtype=torch.int64)
    return out


def copy_tensors(targets: dict[str, torch.Tensor], source: Any, what: str) -> None:
    """Copy source[name] into targets[name] in place (on the targets'
    device) for every name, refusing a missing, extra or reshaped tensor.
    `source` needs `keys()` and `[name]` (a dict, or a TensorFile)."""
    names = set(source.keys())
    if names != set(targets):
        raise ValueError(f"{what}: the source holds {sorted(names - set(targets))} that this "
                         f"run does not and lacks {sorted(set(targets) - names)}")
    with torch.no_grad():
        for name, t in targets.items():
            src = source[name]
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{what}: {name} is {tuple(src.shape)} in the source, "
                                 f"{tuple(t.shape)} in this run")
            t.copy_(src)


def _check_canonical(params: dict[str, torch.Tensor], manifest: StageManifest) -> None:
    """Layer leaves must be the canonical [num_layers, ...] ones."""
    for name, t in params.items():
        if name.startswith("layers.") and t.shape[0] != manifest.num_layers:
            raise ValueError(f"{name} is {tuple(t.shape)}: checkpoints hold the canonical "
                             f"[num_layers={manifest.num_layers}, ...] layer leaves")


@dataclasses.dataclass
class CheckpointManager:
    """Layout: <root>/checkpoint-<step>/{params.safetensors, opt.safetensors,
    meta.json} + <root>/latest."""

    root: str

    def __post_init__(self) -> None:
        os.makedirs(self.root, exist_ok=True)
        self._pending: threading.Thread | None = None  # in-flight async commit
        self._pending_error: BaseException | None = None  # raised on that thread
        self._staging: dict[str, torch.Tensor] = {}  # host copies, reused across saves
        # seconds and bytes of the newest save: the loop's device-to-host copy
        # (`d2h_s`, `d2h_bytes`) and the commit (`write_s`, `digest_s`,
        # `commit_s`, `bytes`; filled when the commit ends)
        self.last_save: dict[str, float] = {}
        # Durability backstop (a caller that lets the process exit after
        # save(blocking=False) must not silently lose meta/tag): finalize on
        # interpreter exit, bounded so a wedged write cannot hold the exit.
        # Weakref so the hook never pins the manager alive.
        import atexit
        import weakref

        ref = weakref.ref(self)
        timeout = float(os.environ.get("LPT_ATEXIT_COMMIT_TIMEOUT_S", "600"))
        atexit.register(
            lambda: (m := ref()) is not None and m.finalize(timeout_s=timeout))

    def finalize(self, timeout_s: float | None = None) -> None:
        """Block until a `save(..., blocking=False)` commit (file writes,
        digests, meta/tag, on_complete hook, prune) finishes. No-op when
        nothing is pending. Re-raises a failure from the background commit:
        a failed periodic checkpoint must surface exactly like a failed
        blocking one.

        `timeout_s` (atexit backstop only): give up after this long -- log
        and abandon the commit instead of wedging interpreter shutdown."""
        t, self._pending = self._pending, None
        if t is not None:
            t.join(timeout_s)
            if t.is_alive():
                # keep tracking the live commit: a later finalize()/save()
                # must re-join THIS thread, not start a second commit racing
                # the shared latest-tag/meta writes
                self._pending = t
                logger.error(
                    "async checkpoint commit still running after %.0fs at "
                    "exit; abandoning the wait (daemon thread dies with the "
                    "process -- the checkpoint stays incomplete and resume "
                    "will ignore it)", timeout_s)
                return
        err, self._pending_error = self._pending_error, None
        if err is not None:
            raise RuntimeError("async checkpoint commit failed") from err

    # -- paths ------------------------------------------------------------

    def step_dir(self, step: int) -> str:
        return os.path.join(self.root, f"checkpoint-{step}")

    def _is_complete(self, name: str) -> bool:
        # meta.json is written LAST, so its presence marks a durably complete
        # checkpoint. A meta.json that exists but does not PARSE marks one
        # that would explode at restore -- quarantine it now so latest_step()
        # falls back instead.
        meta = os.path.join(self.root, name, "meta.json")
        if not os.path.isfile(meta):
            return False

        def read():
            with open(meta) as f:
                return f.read()

        try:
            raw = retry.retry_call(read, policy=_storage_policy(),
                                   non_retryable=(FileNotFoundError,),
                                   describe=f"read {name}/meta.json")
        except FileNotFoundError:
            return False  # quarantined/pruned underneath this scan
        except OSError:
            # a PERSISTENT read failure is a storage outage, not a corruption
            # verdict: neither quarantine a possibly-healthy dir nor answer
            # "incomplete" (a resume would silently restart from step 0)
            logger.error("cannot read %s/meta.json after retries; refusing "
                         "to classify the checkpoint during a storage outage",
                         name)
            raise
        try:
            json.loads(raw)
            return True
        except ValueError:
            self._quarantine(name, "unparseable meta.json")
            return False

    def _quarantine(self, name: str, reason: str) -> str | None:
        """Move checkpoint-N aside to checkpoint-N.corrupt[.k] so no reader
        (latest_step, find_resume_checkpoint, prune) ever considers it again.
        Rename, not delete: the bytes stay for a post-mortem."""
        src = os.path.join(self.root, name)
        dst = src + QUARANTINE_SUFFIX
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = f"{src}{QUARANTINE_SUFFIX}.{n}"
        try:
            os.rename(src, dst)
        except OSError as e:
            logger.warning("could not quarantine %s (%s): %r", name, reason, e)
            return None
        logger.error("quarantined %s -> %s (%s); resume will fall back to "
                     "the previous complete checkpoint", name,
                     os.path.basename(dst), reason)
        return dst

    def latest_tag_value(self) -> str | None:
        """Raw contents of the `latest` tag file, if present."""
        tag = os.path.join(self.root, LATEST_TAG)
        if not os.path.exists(tag):
            return None
        with open(tag) as f:
            return f.read().strip()

    def list_steps(self, complete_only: bool = False) -> list[int]:
        """All checkpoint-N step numbers on disk, ascending. Completeness is
        probed on the ACTUAL dirname, so non-canonical spellings (e.g. a
        hand-copied 'checkpoint-007') are still recognized."""
        self.finalize()  # meta.json of an in-flight async save lands first
        return sorted(int(m.group(1)) for d in os.listdir(self.root)
                      if (m := _CKPT_RE.match(d))
                      and (not complete_only or self._is_complete(d)))

    def is_complete(self, step: int) -> bool:
        """Whether checkpoint-<step> finished durably (meta.json present)."""
        self.finalize()
        for d in os.listdir(self.root):
            m = _CKPT_RE.match(d)
            if m and int(m.group(1)) == step:
                return self._is_complete(d)
        return False

    def latest_step(self) -> int | None:
        self.finalize()
        name = self.latest_tag_value()
        if name is not None:
            m = _CKPT_RE.match(name)
            if m and self._is_complete(name):
                return int(m.group(1))
            logger.warning("stale latest tag %r; falling back to directory scan", name)
        steps = self.list_steps(complete_only=True)
        return max(steps) if steps else None

    # -- save -------------------------------------------------------------

    def prune(self, keep_last: int) -> list[int]:
        """Delete the oldest COMPLETE checkpoints beyond the newest
        `keep_last` (save_total_limit). Incomplete dirs are left alone --
        they are either mid-write or already ignored by every reader.
        Returns the pruned steps."""
        if keep_last < 1:
            raise ValueError(f"keep_last must be >= 1, got {keep_last}")
        # raw listing, NOT list_steps(): prune runs on the async commit
        # thread, and list_steps' finalize() would join the current thread.
        # Deletion goes by the ACTUAL dirname.
        complete = sorted((int(m.group(1)), d) for d in os.listdir(self.root)
                          if (m := _CKPT_RE.match(d)) and self._is_complete(d))
        doomed = complete[:-keep_last]
        for _, dirname in doomed:
            shutil.rmtree(os.path.join(self.root, dirname), ignore_errors=True)
            logger.info("pruned %s (save_total_limit=%d)", dirname, keep_last)
        return [s for s, _ in doomed]

    def _to_host(self, item: str, tensors: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Copies of `tensors` in host memory, complete on return: the loop
        updates its parameters and moments in place, so an async save must
        not read them after `save` returns. The host buffers (pinned, for
        tensors on the card) are kept and reused by the next save."""
        out, on_card = {}, False
        for name, t in tensors.items():
            key = f"{item}/{name}"
            buf = self._staging.get(key)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                pin = t.is_cuda
                buf = torch.empty(t.shape, dtype=t.dtype, pin_memory=pin)
                self._staging[key] = buf
            on_card |= t.is_cuda
            buf.copy_(t.detach(), non_blocking=t.is_cuda)
            out[name] = buf
        if on_card:
            torch.cuda.synchronize()
        return out

    def save(self, step: int, params: dict[str, torch.Tensor] | gather.ShardedState,
             manifest: StageManifest,
             cfg: LlamaConfig, optimizer: Any | None = None,
             blocking: bool = True, on_complete: Any = None,
             keep_last: int | None = None,
             extra_meta: dict | None = None) -> str:
        """Save the train state + metadata, update `latest`. `params` (and the
        optimizer's moments) are the canonical tree, layer leaves
        [num_layers, ...], whatever the run's partition; `manifest` records
        that partition in meta.json (a pipeline run merges its stages'
        chunks first: parallel/pipeline.StageParams.to_canonical).

        `optimizer=None` produces a module-only checkpoint (the converter's
        output); otherwise its `state_dict()` (AdamW: mu, nu, count) goes to
        opt.safetensors. A trainer's state spread over processes (or over
        its stages' chunks) is a gather.ShardedState in place of `params`,
        with no `optimizer`: every process calls `save`, process 0 writes
        the files from every process's pieces and the others serve them.
        The host optimizer's state (a ShardedState of the `offload` layout)
        takes the `offload_parts` files, and meta.json adds `opt_layout` and
        `opt_step_count`; its callers save it blocking (the next step
        updates its masters in place).

        `blocking=False`: every tensor is copied to host memory before
        `save` returns (the caller may update its tensors in place at once),
        while the file writes, digests, meta/tag commit, `on_complete` and
        prune run on a background thread. At most one async commit is in
        flight: the next save (or `finalize()`) joins the previous one
        first, re-raising any background failure.

        `on_complete(path)` runs after the commit (in-thread when async).
        `keep_last` prunes to that many complete checkpoints after the
        commit (None/0: no limit). `extra_meta`: extra JSON-serializable keys
        merged into meta.json (the trainer's `topology` and `data_state`).
        """
        self.finalize()
        # the span covers what the training loop pays for: the copies and,
        # when blocking, the full commit; the async tail is its own
        # `ckpt_commit` span on the commit thread (outside the RunClock's
        # buckets)
        with trace.span("ckpt_save", step=step, blocking=blocking,
                        **({"offload": True} if isinstance(params, gather.ShardedState)
                           and params.offload else {})):
            return self._save(step, params, manifest, cfg, optimizer, blocking, on_complete,
                              keep_last, extra_meta)

    def _save(self, step, params, manifest, cfg, optimizer, blocking, on_complete, keep_last,
              extra_meta) -> str:
        path = self.step_dir(step)
        writer = distributed.process_index() == 0
        shards = params if isinstance(params, gather.ShardedState) else None
        t0 = time.perf_counter()
        copied = {}
        if shards is not None:
            if optimizer is not None:
                raise ValueError("a ShardedState holds the optimizer's state: pass no optimizer")
            if not blocking:
                copied = self._to_host("pieces", shards.owned())
                shards = shards.with_local(copied)
            items = ({_FILES[role]: ts for role, ts in shards.files().items()} if writer
                     else {})
        else:
            items = {PARAMS_FILE: dict(params)}
            if optimizer is not None:
                items[OPT_FILE] = _optimizer_tensors(optimizer)
            if not blocking:
                items = {f: self._to_host(f, ts) for f, ts in items.items()}
                copied = {f"{f}/{n}": t for f, ts in items.items() for n, t in ts.items()}
        if writer:
            _check_canonical(items[PARAMS_FILE], manifest)
        self.last_save = {"d2h_s": 0.0 if blocking else time.perf_counter() - t0,
                          "d2h_bytes": sum(t.numel() * t.element_size()
                                           for t in copied.values())}
        meta_extra = {"has_optimizer_state": shards is not None or optimizer is not None,
                      **(extra_meta or {})}
        if shards is not None and shards.offload:
            meta_extra.update(opt_layout=OFFLOAD_LAYOUT, opt_step_count=shards.count)

        def commit():
            t0 = time.perf_counter()
            nbytes = 0
            if writer:
                if os.path.isdir(path):  # a re-save of this step replaces it whole
                    shutil.rmtree(path)
                os.makedirs(path)
                ok = False
                try:
                    nbytes = sum(tensor_io.write_file(os.path.join(path, f), ts)
                                 for f, ts in items.items())
                    ok = True
                finally:
                    if shards is not None:
                        shards.done(ok)
            elif shards is not None:
                shards.serve()
            t1 = time.perf_counter()
            digest_s = self._commit(path, step, manifest, cfg, **meta_extra)
            if writer and on_complete is not None:
                on_complete(path)
            if writer and keep_last:  # None/0 both mean "no retention limit"
                self.prune(keep_last)
            self.last_save.update(write_s=t1 - t0, digest_s=digest_s, bytes=nbytes,
                                  commit_s=time.perf_counter() - t0)

        if blocking:
            commit()
            return path

        def guarded():
            try:
                with trace.span("ckpt_commit", step=step):
                    commit()
            except BaseException as e:  # surfaced by finalize()
                self._pending_error = e

        self._pending = threading.Thread(target=guarded, name=f"ckpt-commit-{step}",
                                         daemon=True)
        self._pending.start()
        return path

    def _commit(self, path: str, step: int, manifest: StageManifest,
                cfg: LlamaConfig, **meta_extra) -> float:
        """Digest the files, then write meta.json (the completeness marker)
        and the `latest` tag; returns the digest seconds. Every process's
        tensors are durable before the first barrier; the `ckpt_commit`
        fault site fires after it (a `die` there kills the process after the
        files are durable but before the completeness marker); process 0
        alone digests and writes meta.json and the tag, and a second barrier
        ends the commit (both barriers no-ops alone)."""
        distributed.barrier(f"ckpt-arrays-{step}")
        faults.fire("ckpt_commit", tag=path, step=step)
        if distributed.process_index() != 0:
            distributed.barrier(f"ckpt-commit-{step}")
            return 0.0
        meta = {
            "step": step,
            "manifest": dataclasses.asdict(manifest),
            "model_config": _config_meta(cfg),
            "format_version": 1,
            **meta_extra,
            "storage": STORAGE,
        }
        t0 = time.perf_counter()
        if _digests_enabled():
            with trace.span("ckpt_digest", step=step):
                meta["integrity"] = {"algo": "sha256", "files": _dir_digests(path)}
        digest_s = time.perf_counter() - t0
        # atomic + retried: a crash between these two writes leaves a
        # complete, verifiable checkpoint with a stale tag -- which
        # latest_step() already recovers from via the directory scan
        _write_file_atomic(os.path.join(path, "meta.json"), json.dumps(meta, indent=2))
        _write_file_atomic(os.path.join(self.root, LATEST_TAG), f"checkpoint-{step}")
        distributed.barrier(f"ckpt-commit-{step}")
        logger.info("saved checkpoint-%d to %s", step, path)
        return digest_s

    # -- integrity ---------------------------------------------------------

    def verify(self, step: int) -> None:
        """Recompute the per-file digests recorded at commit and compare.

        Raises CheckpointCorruptError -- after quarantining the directory --
        on any mismatch or missing file, so a restore can never silently
        consume a bit-flipped or truncated file. A meta.json without
        `integrity` (LPT_CKPT_DIGESTS=0 at save) passes with a log line."""
        with trace.span("ckpt_verify", step=step):
            self._verify(step)

    def _verify(self, step: int) -> None:
        path = self.step_dir(step)
        name = os.path.basename(path)
        try:
            meta = self.load_meta(step)
        except FileNotFoundError as e:
            # already invisible to every reader: nothing to quarantine
            raise CheckpointCorruptError(f"{name}: meta.json missing: {e}") from e
        except ValueError as e:
            # readable bytes that do not parse: corruption, not an outage
            self._quarantine(name, f"unparseable meta.json ({e!r})")
            raise CheckpointCorruptError(f"{name}: meta.json unparseable: {e}") from e
        # any other OSError (persistent storage outage) propagates untouched:
        # same do-not-quarantine-on-I/O-failure policy as _is_complete
        integrity = meta.get("integrity")
        if not integrity:
            logger.info("%s has no integrity digests; skipping verification", name)
            return
        bad: list[str] = []
        present: dict[str, str] = {}
        for rel in integrity.get("files", {}):
            full = os.path.join(path, rel.replace("/", os.sep))
            if os.path.isfile(full):
                present[rel] = full
            else:
                bad.append(f"{rel}: missing")
        got = _digests(present)
        for rel, want in integrity.get("files", {}).items():
            if rel in got and got[rel] != want:
                bad.append(f"{rel}: sha256 {got[rel][:12]}... != recorded {want[:12]}...")
        if bad:
            self._quarantine(name, f"{len(bad)} corrupt item(s)")
            raise CheckpointCorruptError(
                f"{name} failed integrity verification: " + "; ".join(bad))
        logger.info("%s verified (%d files)", name, len(integrity.get("files", {})))

    def verify_everywhere(self, step: int) -> None:
        """`verify(step)` for a restore by every process: alone, verify;
        under several processes process 0 verifies (quarantining a corrupt
        checkpoint) and every process raises CheckpointCorruptError on its
        verdict, so all of them fall back together."""
        if distributed.process_count() == 1:
            self.verify(step)
            return
        err = None
        if distributed.process_index() == 0:
            try:
                self.verify(step)
            except CheckpointCorruptError as e:
                err = e
        if distributed.should_stop(err is not None):
            raise err or CheckpointCorruptError(
                f"checkpoint-{step} failed verification on process 0 (quarantined there)")

    # -- load -------------------------------------------------------------

    def load_meta(self, step: int) -> dict:
        self.finalize()
        meta_path = os.path.join(self.step_dir(step), "meta.json")

        def read():
            with open(meta_path) as f:
                return json.load(f)

        return retry.retry_call(read, policy=_storage_policy(),
                                non_retryable=(FileNotFoundError,),
                                describe=f"read {meta_path}")

    def _read(self, step: int, filename: str, fn) -> None:
        """Open one file of checkpoint-<step> and run fn(TensorFile) under
        the storage retry policy (the copies are idempotent). A dir that
        vanished mid-restore is a corruption verdict to fall back from."""
        full = os.path.join(self.step_dir(step), filename)

        def read():
            faults.fire("storage_write", tag=full)
            with tensor_io.TensorFile(full) as f:
                fn(f)

        try:
            retry.retry_call(read, policy=_storage_policy(),
                             non_retryable=(FileNotFoundError,),
                             describe=f"read {filename}")
        except FileNotFoundError as e:
            if not os.path.isfile(os.path.join(self.step_dir(step), "meta.json")):
                raise CheckpointCorruptError(
                    f"checkpoint-{step} disappeared mid-restore: {e}") from e
            raise

    def _check_storage(self, step: int, meta: dict) -> None:
        if meta.get("storage") != STORAGE:
            raise ValueError(
                f"checkpoint-{step} under {self.root} has no \"storage\": \"{STORAGE}\" in "
                f"its meta.json: it was written by the JAX package (Orbax arrays), which "
                f"this package does not read; {HF_ROUTE}")

    def load_params(self, step: int, params: dict[str, torch.Tensor],
                    manifest: StageManifest | None = None,
                    verify: bool | None = None, copy: Any = None) -> dict[str, torch.Tensor]:
        """Module-only warm start: copy checkpoint-<step>'s parameters into
        `params` (in place, on their device) and return them. Both are the
        canonical [num_layers, ...] tree, whatever partition `manifest` (the
        run's) names: a restore across a change of pp, schedule or layer
        counts is a copy. Either optimizer layout holds the same params file.
        `copy(targets, source, what)` copies a file's canonical tensors into
        targets named otherwise (a pipeline's chunks); None: same names.

        `verify` (default: on, unless LPT_CKPT_VERIFY=0): check the commit's
        recorded digests first; corruption quarantines the checkpoint and
        raises CheckpointCorruptError instead of restoring garbage."""
        if manifest is not None:
            _check_canonical(params, manifest)
        if _verify_default() if verify is None else verify:
            self.verify_everywhere(step)
        self._check_storage(step, self.load_meta(step))
        copy = copy or copy_tensors
        with trace.span("ckpt_restore", step=step, item="params"):
            self._read(step, PARAMS_FILE,
                       lambda f: copy(params, f, f"checkpoint-{step}/{PARAMS_FILE}"))
        return params

    def load_offload_moments(self, step: int, m: dict[str, torch.Tensor],
                             v: dict[str, torch.Tensor], verify: bool | None = None,
                             copy: Any = None) -> int:
        """The host optimizer's moments of an `offload_parts` checkpoint into
        `m` and `v` in place (one file at a time; `copy` as in load_params);
        returns its step count. Refuses another layout."""
        if _verify_default() if verify is None else verify:
            self.verify_everywhere(step)
        meta = self.load_meta(step)
        self._check_storage(step, meta)
        if meta.get("opt_layout") != OFFLOAD_LAYOUT:
            raise ValueError(f"checkpoint-{step} was not written by the offloaded optimizer "
                             f"(opt_layout={meta.get('opt_layout')!r})")
        copy = copy or copy_tensors
        with trace.span("ckpt_restore", step=step, item="offload_moments"):
            for filename, targets in ((OPT_M_FILE, m), (OPT_V_FILE, v)):
                self._read(step, filename, lambda f, targets=targets, filename=filename: copy(
                    targets, f, f"checkpoint-{step}/{filename}"))
        return int(meta["opt_step_count"])

    def load(self, step: int, params: dict[str, torch.Tensor], optimizer: Any,
             manifest: StageManifest | None = None, verify: bool | None = None,
             copy: Any = None) -> tuple[dict[str, torch.Tensor], Any, int]:
        """Full-state resume: params and the optimizer's state (moments and
        count) in place. One `verify(step)` covers every file in the dir.
        `copy` as in load_params (the params only: the optimizer's
        `load_state_dict` takes the canonical moments and keeps its own)."""
        if _verify_default() if verify is None else verify:
            self.verify_everywhere(step)
        meta = self.load_meta(step)
        self._check_storage(step, meta)
        if not meta.get("has_optimizer_state"):
            raise ValueError(
                f"checkpoint-{step} has no optimizer state (module-only / "
                f"converter output); use load_params for a warm start")
        if meta.get("opt_layout") == OFFLOAD_LAYOUT:
            raise ValueError(
                f"checkpoint-{step} was written by the host-offloaded optimizer "
                f"(opt_layout={OFFLOAD_LAYOUT}); resume it with optimizer_offload: true, or "
                f"warm-start module-only via model_name_or_path")
        self.load_params(step, params, manifest, verify=False, copy=copy)

        def read_opt(f: tensor_io.TensorFile) -> None:
            if "count" not in f:
                raise ValueError(f"checkpoint-{step}/{OPT_FILE}: no `count`")
            state: dict[str, Any] = {"count": int(f.tensor("count"))}
            for moment in ("mu", "nu"):
                state[moment] = {k[len(moment) + 1:]: f.tensor(k) for k in f.keys()
                                 if k.startswith(moment + ".")}
            optimizer.load_state_dict(state)

        with trace.span("ckpt_restore", step=step, item="opt"):
            self._read(step, OPT_FILE, read_opt)
        return params, optimizer, int(meta["step"])


def config_from_meta(meta: dict) -> LlamaConfig:
    """The LlamaConfig a checkpoint recorded; dtypes from the config's
    defaults, not the training run's (tools cast as they need)."""
    mc = dict(meta["model_config"])
    mc.pop("dtype", None), mc.pop("param_dtype", None)
    return LlamaConfig(**mc)


def load_module_checkpoint(checkpoint_dir: str, step: int | None = None,
                           device: str | torch.device = "cuda"
                           ) -> tuple[dict[str, torch.Tensor], LlamaConfig, StageManifest, int]:
    """Canonical-layout params + config + manifest from a checkpoint dir:
    resolves `step` (default: latest), rebuilds the LlamaConfig and
    StageManifest from meta.json, and returns fp32 params with layer leaves
    `[num_layers, ...]` on `device`."""
    mgr = CheckpointManager(checkpoint_dir)
    if step is None:
        step = mgr.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {checkpoint_dir}")
    meta = mgr.load_meta(step)
    mgr._check_storage(step, meta)
    cfg = config_from_meta(meta)
    manifest = StageManifest(**meta["manifest"])
    params = {name: torch.empty(shape, dtype=cfg.param_dtype, device=device)
              for name, shape in param_shapes(cfg).items()}
    mgr.load_params(step, params)
    return params, cfg, manifest, step


def find_resume_checkpoint(root: str) -> tuple[int, str] | None:
    """The newest complete checkpoint under `root`, as (step, path)."""
    if not os.path.isdir(root):
        return None
    mgr = CheckpointManager(root)
    step = mgr.latest_step()
    if step is None:
        return None
    return step, mgr.step_dir(step)
