"""The port's checkpoint layer (ckpt/checkpoint.py), stage manifest, retry
policy and the trainer's save / resume surface, against the JAX package's.

The manifest, retry policy, meta.json, topology and data-state records are
pinned to the reference's on the same inputs (exact equality: they are
integers, strings and JSON). Resume on the CPU is held bit for bit to the
uninterrupted run: losses, params, moments and the step count. The integrity
cases mirror tests/test_ckpt.py's.
"""

import dataclasses
import importlib
import json
import os
import random
import types

import jax
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.ckpt import checkpoint as t_ckpt
from llama_pipeline_parallel_tpu_torch.data import collator as t_collator
from llama_pipeline_parallel_tpu_torch.data import datasets as t_datasets
from llama_pipeline_parallel_tpu_torch.data import loader as t_loader
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.optim import optimizer as t_optim
from llama_pipeline_parallel_tpu_torch.utils import config as t_config
from llama_pipeline_parallel_tpu_torch.utils import retry as t_retry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_SMOKE = os.path.join(REPO, "conf", "tiny_smoke.yaml")
# one device, 4 steps of a 24-row dataset at batch 4: 6 steps an epoch
ONE = ["mesh.pp=1", "mesh.dp=1", "max_steps=4", "total_steps=8", "warmup_steps=1",
       "dataset.pseudo_dataset_len=24", "save_final=false"]


@pytest.fixture(scope="session")
def ref():
    """The reference modules, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (imported by the reference's host stash, never constructed on the CPU)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    mods = {"ckpt": "ckpt.checkpoint", "manifest": "models.llama.manifest",
            "config": "models.llama.config", "llama": "models.llama.model",
            "retry": "utils.retry", "train": "train", "mesh": "parallel.mesh",
            "pl": "parallel.pipeline", "optim": "optim", "cfgio": "utils.config",
            "loader": "data.loader", "datasets": "data.datasets",
            "collator": "data.collator"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


def _tiny_cfg(*overrides):
    return t_config.load_config(TINY_SMOKE, ONE + list(overrides))


def _params(seed=0):
    cfg = TConfig.tiny()
    return cfg, t_llama.init_params(cfg, seed, device="cpu")


def _one_stage(cfg):
    return TManifest(num_layers=cfg.num_hidden_layers, num_stages=1)


def _optimizer(params):
    opt = t_optim.AdamW(params, t_optim.OptimizerConfig(total_steps=10, warmup_steps=1))
    for moment in (opt.mu, opt.nu):
        for k, v in moment.items():
            v.copy_(torch.randn(v.shape, generator=torch.Generator().manual_seed(len(k))))
    opt.count = 3
    return opt


# ---------------------------------------------------------------------------
# manifest and retry: copies, pinned to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("layers,stages,counts,virtual", [
    (4, 1, None, 1), (8, 2, None, 1), (8, 2, None, 2), (12, 4, None, 3),
    (10, 4, (3, 3, 2, 2), 1), (32, 4, None, 1), (10, 4, None, 1),
])
def test_manifest_matches_reference(ref, layers, stages, counts, virtual):
    """for_config / balanced / the explicit form, their JSON, the per-stage
    geometry and the refusals equal the reference's."""
    rcfg = ref.config.LlamaConfig.tiny(num_hidden_layers=layers)
    tcfg = TConfig.tiny(num_hidden_layers=layers)

    def both(fn_ref, fn_port):
        try:
            want = fn_ref()
        except ValueError as e:
            with pytest.raises(ValueError, match=str(e)[:30].replace("(", r"\(")):
                fn_port()
            return None, None
        return want, fn_port()

    cases = [
        both(lambda: ref.manifest.StageManifest.for_config(rcfg, stages, virtual),
             lambda: TManifest.for_config(tcfg, stages, virtual)),
        both(lambda: ref.manifest.StageManifest.balanced(rcfg, stages),
             lambda: TManifest.balanced(tcfg, stages)),
        both(lambda: ref.manifest.StageManifest(layers, stages, counts, virtual),
             lambda: TManifest(layers, stages, counts, virtual)),
    ]
    for want, got in cases:
        if want is None:
            continue
        assert got.to_json() == want.to_json()
        assert TManifest.from_json(want.to_json()) == got
        assert got.stage_layer_counts == want.stage_layer_counts
        assert got.stage_offsets() == want.stage_offsets()
        assert [got.stage_of_layer(i) for i in range(layers)] == \
            [want.stage_of_layer(i) for i in range(layers)]
        assert [list(got.layers_of_stage(s)) for s in range(stages)] == \
            [list(want.layers_of_stage(s)) for s in range(stages)]
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_retry_policy_from_env_matches_reference(ref, monkeypatch):
    """The policy read from the same LPT_RETRY_* env, and its backoff delays
    for the same jitter seed, equal the reference's."""
    for env in ({}, {"LPT_RETRY_MAX_ATTEMPTS": "7", "LPT_RETRY_BASE_DELAY_S": "0.25",
                     "LPT_RETRY_MAX_DELAY_S": "3"}):
        for var in ("LPT_RETRY_MAX_ATTEMPTS", "LPT_RETRY_BASE_DELAY_S", "LPT_RETRY_MAX_DELAY_S"):
            monkeypatch.delenv(var, raising=False)
        for var, val in env.items():
            monkeypatch.setenv(var, val)
        want, got = ref.retry.RetryPolicy.from_env(), t_retry.RetryPolicy.from_env()
        assert dataclasses.asdict(got) == dataclasses.asdict(want)
        assert dataclasses.asdict(t_retry.RetryPolicy.from_env(jitter=0.5)) == \
            dataclasses.asdict(ref.retry.RetryPolicy.from_env(jitter=0.5))
        delays = [(want.delay_s(a, random.Random(3)), got.delay_s(a, random.Random(3)))
                  for a in range(1, 9)]
        assert [d[0] for d in delays] == [d[1] for d in delays]
    with pytest.raises(ValueError, match="max_attempts"):
        t_retry.RetryPolicy(max_attempts=0)


@pytest.mark.parametrize("error,fails,non_retryable", [
    (OSError, 2, ()), (OSError, 5, ()), (FileNotFoundError, 1, (FileNotFoundError,)),
    (ValueError, 1, ()), (None, 0, ()),
])
def test_retry_call_matches_reference(ref, monkeypatch, error, fails, non_retryable):
    """retry_call retries what it should, stops where it should, and raises
    or returns what the reference does, with the same on_retry attempts."""
    monkeypatch.setenv("LPT_RETRY_BASE_DELAY_S", "0.001")
    monkeypatch.setenv("LPT_RETRY_MAX_DELAY_S", "0.002")
    outcomes = []
    for mod in (ref.retry, t_retry):
        calls, retries = [], []

        def fn():
            calls.append(1)
            if len(calls) <= fails:
                raise error("blip")
            return "done"

        try:
            result = mod.retry_call(fn, non_retryable=non_retryable, seed=0,
                                    on_retry=lambda a, e: retries.append(a))
        except Exception as e:  # noqa: BLE001 -- the outcome is compared
            result = type(e)
        outcomes.append((result, len(calls), retries))
    assert outcomes[1] == outcomes[0]


# ---------------------------------------------------------------------------
# meta.json, topology and data state, pinned to the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_optimizer", [False, True])
def test_meta_json_matches_reference(ref, tmp_path, with_optimizer):
    """For the same step, config, manifest and extra keys, every key of the
    reference's meta.json has the reference's value in the port's; the
    integrity file lists and `storage` are the only differences."""
    rcfg = ref.config.LlamaConfig.tiny()
    rman = ref.manifest.StageManifest.for_config(rcfg, 1)
    tree = ref.llama.init_params(jax.random.PRNGKey(0), rcfg)
    tx, _ = ref.optim.make_optimizer(ref.optim.OptimizerConfig(total_steps=10, warmup_steps=1))
    extra = {"topology": {"layout": "pp1xdp1xtp1xsp1", "process_count": 1},
             "data_state": {"epoch": 0, "consumed_samples": 8}}
    stacked = ref.pl.stack_stages(tree, rman)
    ref.ckpt.CheckpointManager(str(tmp_path / "ref")).save(
        2, stacked, rman, rcfg, opt_state=tx.init(stacked) if with_optimizer else None,
        extra_meta=extra)
    tcfg = TConfig.tiny()
    params = convert.params_from_jax(jax.device_get(tree))
    t_ckpt.CheckpointManager(str(tmp_path / "port")).save(
        2, params, _one_stage(tcfg), tcfg,
        optimizer=_optimizer(params) if with_optimizer else None, extra_meta=extra)
    want = json.load(open(tmp_path / "ref" / "checkpoint-2" / "meta.json"))
    got = json.load(open(tmp_path / "port" / "checkpoint-2" / "meta.json"))
    assert set(got) - set(want) == {"storage"} and got["storage"] == "safetensors"
    assert set(want) <= set(got)
    for key in want:
        if key != "integrity":
            assert got[key] == want[key], key
    assert got["integrity"]["algo"] == want["integrity"]["algo"] == "sha256"
    files = ["params.safetensors"] + (["opt.safetensors"] if with_optimizer else [])
    assert sorted(got["integrity"]["files"]) == sorted(files)
    assert open(tmp_path / "port" / "latest").read() == "checkpoint-2"


def test_topology_meta_matches_reference(ref, devices):
    """`_topology_meta` of a one-device run equals the reference's on a
    one-device CPU mesh with the same config."""
    cfg = _tiny_cfg()
    mesh_cfg = ref.mesh.MeshConfig(pp=1, dp=1)
    rmodel = ref.train.build_model_config(cfg["model"])
    rman = ref.train.build_manifest(cfg, rmodel, 1)
    pcfg = ref.train.build_pipeline_config(cfg, mesh_cfg, rman)
    want = ref.train._topology_meta(ref.mesh.make_mesh(mesh_cfg), pcfg, rman)
    got = t_train._topology_meta(cfg, _one_stage(t_train.build_model_config(cfg["model"])))
    assert got == want


def _loaders(ref, batch, length=24, seed=3):
    kw = dict(vocab_size=64, seq_length=8, pseudo_dataset_len=length, seed=seed)
    return (ref.loader.DataLoader(ref.datasets.SyntheticDataset(**kw),
                                  ref.collator.PretokenizedCollator(),
                                  per_replica_batch=batch, seed=seed),
            t_loader.DataLoader(t_datasets.SyntheticDataset(**kw),
                                t_collator.PretokenizedCollator(),
                                per_replica_batch=batch, seed=seed))


class _Meta:
    """Stands in for a CheckpointManager whose checkpoint holds `data_state`."""

    def __init__(self, data_state):
        self.data_state = data_state

    def load_meta(self, step):
        return {"data_state": self.data_state}


@pytest.mark.parametrize("step,delta,resume_batch,resume_seed", [
    (0, 0, 4, 3), (3, 0, 4, 3), (6, 0, 4, 3), (7, 0, 4, 3), (13, 0, 4, 3),
    (5, 2, 4, 3), (6, 0, 8, 3), (9, 0, 2, 3), (4, 0, 4, 5),
])
def test_data_state_and_resume_position_match_reference(ref, step, delta, resume_batch,
                                                        resume_seed):
    """`_data_state` at a step (across an epoch wrap, with a batch delta) and
    `_resume_data_position` from it (unchanged or changed global batch, a
    changed seed) equal the reference's; the position opens the port's
    loader at the batch the uninterrupted stream would give."""
    r_loader, t_loader_ = _loaders(ref, 4)
    want = ref.train._data_state(step, r_loader, 24, 3, delta)
    got = t_train._data_state(step, t_loader_, 24, 3, delta)
    assert got == want
    r_resume, t_resume = _loaders(ref, resume_batch)
    pos = t_train._resume_data_position(_Meta(got), step, t_resume, 24, resume_seed)
    assert pos == ref.train._resume_data_position(_Meta(want), step, r_resume, 24, resume_seed)
    if resume_batch == 4 and resume_seed == 3:
        stream = iter(t_loader.RepeatingLoader(t_loader_))
        for _ in range(step + delta):
            next(stream)
        resumed = next(iter(t_loader.RepeatingLoader(t_resume, *pos)))
        for key, arr in next(stream).items():
            np.testing.assert_array_equal(resumed[key], arr)


# ---------------------------------------------------------------------------
# resume on the CPU: bit for bit
# ---------------------------------------------------------------------------

def _assert_same_state(a, b):
    for k, v in a.params.items():
        assert torch.equal(v, b.params[k]), k
    for moment in ("mu", "nu"):
        for k, v in getattr(a.optimizer, moment).items():
            assert torch.equal(v, getattr(b.optimizer, moment)[k]), (moment, k)
    assert a.optimizer.count == b.optimizer.count and a.step == b.step


@pytest.mark.parametrize("async_save", [False, True])
def test_resumed_run_equals_uninterrupted_run(tmp_path, async_save):
    """4 steps in one run equal 2 steps saved at step 2 (save_steps=2)
    followed by a resumed run to step 4: losses, params, moments and count,
    bit for bit; the resumed run restores step 2 at consumed_samples 2 G."""
    full = t_train.build_run(_tiny_cfg(f"output_dir={tmp_path}/full"), "cpu")
    want = t_train.train_run(full)
    split = [f"output_dir={tmp_path}/split", "save_steps=2", f"async_save={async_save}"]
    first = t_train.run_training(_tiny_cfg(*split, "max_steps=2"), device="cpu")
    meta = json.load(open(tmp_path / "split" / "checkpoint-2" / "meta.json"))
    assert meta["has_optimizer_state"] and meta["step"] == 2
    assert meta["data_state"]["consumed_samples"] == 2 * 4
    resumed = t_train.build_run(_tiny_cfg(*split), "cpu")
    assert (resumed.start_step, resumed.data_start) == (2, (0, 2))
    second = t_train.train_run(resumed)
    assert first["losses"] + second["losses"] == want["losses"]
    assert second["start_step"] == 2 and len(second["losses"]) == 2
    _assert_same_state(resumed.state, full.state)
    assert t_ckpt.CheckpointManager(str(tmp_path / "split")).list_steps() == [2, 4]


@pytest.mark.parametrize("override", ["async_save=true", "save_total_limit=1"])
def test_trainer_saves_with_async_save_and_save_total_limit(tmp_path, override):
    """async_save and save_total_limit, once refused, now save: every
    save_steps and once at the end (save_final), the final save blocking;
    save_total_limit keeps the newest; save_sync_command runs on each
    committed checkpoint."""
    log = tmp_path / "synced.txt"
    t_train.run_training(_tiny_cfg(f"output_dir={tmp_path}/run", "save_steps=3",
                                   "save_final=true", override,
                                   f"save_sync_command='echo {{path}} >> {log}'"), "cpu")
    steps = t_ckpt.CheckpointManager(str(tmp_path / "run")).list_steps(complete_only=True)
    assert steps == ([4] if override == "save_total_limit=1" else [3, 4])
    assert [os.path.basename(x) for x in open(log).read().split()] == \
        ["checkpoint-3", "checkpoint-4"]


def test_trainer_resumes_across_an_epoch_and_a_changed_batch(tmp_path):
    """Resume reopens the stream by divmod past an epoch's end, and a
    changed global batch remaps by consumed samples."""
    out = f"output_dir={tmp_path}"
    t_train.run_training(_tiny_cfg(out, "max_steps=7", "total_steps=12", "save_final=true"),
                         "cpu")
    run = t_train.build_run(_tiny_cfg(out, "max_steps=9", "total_steps=12"), "cpu")
    assert (run.start_step, run.data_start) == (7, (1, 1))
    run = t_train.build_run(_tiny_cfg(out, "max_steps=9", "total_steps=12",
                                      "gradient_accumulation_steps=1"), "cpu")
    assert (run.start_step, run.data_start) == (7, (1, 2))  # 28 samples at G = 2


# ---------------------------------------------------------------------------
# integrity (tests/test_ckpt.py's cases)
# ---------------------------------------------------------------------------

def _saved(root, steps=(2, 4), optimizer=True):
    cfg, params = _params()
    mgr = t_ckpt.CheckpointManager(str(root))
    for s in steps:
        mgr.save(s, params, _one_stage(cfg), cfg,
                 optimizer=_optimizer(params) if optimizer else None)
    return mgr, cfg, params


def _flip_byte(path, offset=-5):
    with open(path, "r+b") as f:
        f.seek(offset, os.SEEK_END)
        byte = f.read(1)
        f.seek(offset, os.SEEK_END)
        f.write(bytes([byte[0] ^ 0xFF]))


def test_flipped_byte_quarantines_and_restore_falls_back(tmp_path):
    """A flipped byte in the newest checkpoint fails verification, which
    quarantines it; the trainer's restore falls back to the previous one."""
    t_train.run_training(_tiny_cfg(f"output_dir={tmp_path}", "save_steps=2"), "cpu")
    _flip_byte(tmp_path / "checkpoint-4" / "params.safetensors")
    run = t_train.build_run(_tiny_cfg(f"output_dir={tmp_path}", "max_steps=6"), "cpu")
    assert run.start_step == 2
    assert sorted(os.listdir(tmp_path)) == ["checkpoint-2", "checkpoint-4.corrupt", "health.json",
                                            "latest", "metrics.jsonl", "numerics.jsonl",
                                            "spans.jsonl", "training_config.json"]
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    _flip_byte(tmp_path / "checkpoint-2" / "opt.safetensors", offset=-100)
    with pytest.raises(t_ckpt.CheckpointCorruptError, match="opt.safetensors: sha256"):
        mgr.verify(2)
    assert t_ckpt.find_resume_checkpoint(str(tmp_path)) is None
    assert os.path.isdir(tmp_path / "checkpoint-2.corrupt")


def test_unparseable_meta_is_quarantined(tmp_path):
    mgr, _, _ = _saved(tmp_path)
    (tmp_path / "checkpoint-4" / "meta.json").write_text('{"step": 4, "manif')
    assert mgr.latest_step() == 2
    assert os.path.isdir(tmp_path / "checkpoint-4.corrupt")
    (tmp_path / "checkpoint-2" / "meta.json").write_text("not json")
    with pytest.raises(t_ckpt.CheckpointCorruptError, match="unparseable"):
        mgr.verify(2)
    assert os.path.isdir(tmp_path / "checkpoint-2.corrupt")


def test_incomplete_dir_is_ignored(tmp_path):
    mgr, _, _ = _saved(tmp_path, steps=(2,))
    os.makedirs(mgr.step_dir(9))
    (tmp_path / "checkpoint-9" / "params.safetensors").write_bytes(b"partial")
    assert mgr.list_steps() == [2, 9] and mgr.list_steps(complete_only=True) == [2]
    assert not mgr.is_complete(9) and mgr.latest_step() == 2
    assert t_ckpt.find_resume_checkpoint(str(tmp_path))[0] == 2


def test_stale_latest_tag_falls_back_to_scan(tmp_path):
    mgr, _, _ = _saved(tmp_path)
    for tag in ("!!torn write garbage", "checkpoint-999"):
        (tmp_path / "latest").write_text(tag)
        assert mgr.latest_tag_value() == tag and mgr.latest_step() == 4
    os.rename(mgr.step_dir(4), mgr.step_dir(4) + ".corrupt")
    (tmp_path / "latest").write_text("checkpoint-4")
    step, path = t_ckpt.find_resume_checkpoint(str(tmp_path))
    assert step == 2 and path.endswith("checkpoint-2")
    assert t_ckpt.find_resume_checkpoint(str(tmp_path / "nope")) is None


def test_prune_keeps_newest_and_leaves_incomplete(tmp_path):
    mgr, cfg, params = _saved(tmp_path, steps=(2, 3), optimizer=False)
    os.makedirs(mgr.step_dir(0))  # incomplete: never pruned
    odd = tmp_path / "checkpoint-001"  # complete, non-canonical name
    odd.mkdir()
    (odd / "meta.json").write_text("{}")
    mgr.save(4, params, _one_stage(cfg), cfg, blocking=False, keep_last=2)
    mgr.finalize()
    assert mgr.list_steps(complete_only=True) == [3, 4]
    assert not odd.exists() and os.path.isdir(mgr.step_dir(0))
    assert mgr.latest_step() == 4
    with pytest.raises(ValueError, match="keep_last"):
        mgr.prune(0)


def test_failing_background_commit_reraises_from_finalize(tmp_path):
    cfg, params = _params()
    mgr = t_ckpt.CheckpointManager(str(tmp_path))

    def boom(*a, **k):
        raise OSError("disk full")

    mgr._commit = boom
    mgr.save(2, params, _one_stage(cfg), cfg, blocking=False)
    with pytest.raises(RuntimeError, match="async checkpoint commit failed"):
        mgr.finalize()
    mgr.finalize()  # the error is consumed; the manager stays usable
    assert not mgr.is_complete(2)


def test_async_save_copies_before_returning(tmp_path):
    """blocking=False returns after the host copy: updating the tensors in
    place afterwards does not change what lands on disk, and the host
    buffers are reused by the next save."""
    cfg, params = _params()
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    want = {k: v.clone() for k, v in params.items()}
    opt = _optimizer(params)
    mgr.save(2, params, _one_stage(cfg), cfg, optimizer=opt, blocking=False)
    staged = {k: v.data_ptr() for k, v in mgr._staging.items()}
    for v in params.values():
        v.add_(1.0)
    mgr.finalize()
    got = {k: torch.empty_like(v) for k, v in params.items()}
    mgr.load_params(2, got)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    mgr.save(3, params, _one_stage(cfg), cfg, optimizer=opt, blocking=False)
    assert {k: v.data_ptr() for k, v in mgr._staging.items()} == staged
    mgr.finalize()
    assert mgr.last_save["bytes"] > 0 and mgr.last_save["d2h_bytes"] > 0


def test_module_only_checkpoint_refuses_full_resume(tmp_path):
    mgr, cfg, params = _saved(tmp_path, steps=(0,), optimizer=False)
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    with pytest.raises(ValueError, match="no optimizer state"):
        mgr.load(0, fresh, t_optim.AdamW(fresh, t_optim.OptimizerConfig()))
    mgr.load_params(0, fresh)
    for k, v in params.items():
        assert torch.equal(fresh[k], v), k
    loaded, lcfg, manifest, step = t_ckpt.load_module_checkpoint(str(tmp_path), device="cpu")
    # dtypes come from the config's defaults, not the run's
    assert (step, lcfg, manifest) == (0, dataclasses.replace(cfg, dtype=torch.bfloat16),
                                      _one_stage(cfg))
    for k, v in params.items():
        assert torch.equal(loaded[k], v), k
    with pytest.raises(ValueError, match="lm_head"):
        mgr.load_params(0, {k: v for k, v in fresh.items() if k != "lm_head"})


def test_full_restore_round_trips(tmp_path):
    mgr, cfg, params = _saved(tmp_path, steps=(5,))
    want = _optimizer(params)
    fresh = {k: torch.zeros_like(v) for k, v in params.items()}
    opt = t_optim.AdamW(fresh, t_optim.OptimizerConfig())
    _, _, step = mgr.load(5, fresh, opt)
    assert step == 5 and opt.count == want.count == 3
    for moment in ("mu", "nu"):
        for k, v in getattr(want, moment).items():
            assert torch.equal(getattr(opt, moment)[k], v), (moment, k)


def test_digest_and_verify_knobs(tmp_path, monkeypatch):
    """LPT_CKPT_DIGESTS=0 writes no integrity record (verify passes with a
    log line); LPT_CKPT_VERIFY=0 restores without hashing."""
    monkeypatch.setenv("LPT_CKPT_DIGESTS", "0")
    mgr, cfg, params = _saved(tmp_path, steps=(1,), optimizer=False)
    assert "integrity" not in mgr.load_meta(1)
    mgr.verify(1)
    monkeypatch.delenv("LPT_CKPT_DIGESTS")
    mgr.save(2, params, _one_stage(cfg), cfg)
    _flip_byte(tmp_path / "checkpoint-2" / "params.safetensors")
    monkeypatch.setenv("LPT_CKPT_VERIFY", "0")
    mgr.load_params(2, {k: torch.empty_like(v) for k, v in params.items()})
    assert mgr.is_complete(2)


def test_jax_package_checkpoint_is_refused_by_name(ref, tmp_path):
    """A checkpoint of the JAX package (Orbax arrays, no `storage` in
    meta.json) is refused, naming the HF route, by the loader and by the
    trainer's resume."""
    rcfg = ref.config.LlamaConfig.tiny()
    rman = ref.manifest.StageManifest.for_config(rcfg, 1)
    tree = ref.llama.init_params(jax.random.PRNGKey(0), rcfg)
    tx, _ = ref.optim.make_optimizer(ref.optim.OptimizerConfig(total_steps=10, warmup_steps=1))
    stacked = ref.pl.stack_stages(tree, rman)
    ref.ckpt.CheckpointManager(str(tmp_path)).save(3, stacked, rman, rcfg,
                                                   opt_state=tx.init(stacked))
    cfg, params = _params()
    mgr = t_ckpt.CheckpointManager(str(tmp_path))
    assert mgr.latest_step() == 3
    with pytest.raises(ValueError, match="JAX package.*export_hf"):
        mgr.load_params(3, params)
    with pytest.raises(ValueError, match="convert_hf"):
        t_train.build_run(_tiny_cfg(f"output_dir={tmp_path}"), "cpu")


# ---------------------------------------------------------------------------
# checkpoints across processes (pp 2 x dp 2, gloo ranks on the CPU)
# ---------------------------------------------------------------------------

# tiny_smoke's own pp 2 x dp 2, 6 steps of a 64-row dataset; at dp 1 the
# replica takes both replicas' rows (the same global batch of 8)
CROSS = ["dataset.pseudo_dataset_len=64", "logging_steps=1", "total_steps=6",
         "save_final=false"]
DP1 = ["mesh.dp=1", "gradient_accumulation_steps=4"]


def _metric_losses(out_dir, steps=None):
    """The metrics lines' losses, or those of the last len(steps) lines, which
    must be of `steps` (a resume appends to the copied run's file)."""
    rows = [json.loads(x) for x in open(os.path.join(out_dir, "metrics.jsonl"))]
    rows = [r for r in rows if "loss" in r]
    if steps is not None:
        rows = rows[-len(steps):]
        assert [r["step"] for r in rows] == list(steps)
    return [r["loss"] for r in rows]


@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """4 processes train 6 steps uninterrupted ("straight"); 4 more save at
    step 2 and die at step 4's commit (`ckpt_commit` die after the tensors'
    barrier: "saved"). From copies of the saved run's directory: resumes at
    pp 2 x dp 2 (4 processes, and 2: every stage in each), pp 2 x dp 1 (2)
    and pp 1 x dp 1 (this process) to step 6, and a resume that saves step 2 again at once
    (4 processes, "resaved"). Returns {name: directory} and the resumes'
    losses and return codes."""
    from tests.test_torch_dp import cli, finish, launch
    import shutil

    root = tmp_path_factory.mktemp("cross")
    die = json.dumps({"faults": [{"site": "ckpt_commit", "op": "die", "at_step": 4}]})
    straight = launch(4, cli(*CROSS, "max_steps=6", "resume=false", f"output_dir={root}/straight"))
    saved = launch(4, cli(*CROSS, "max_steps=4", "save_steps=2", "resume=false",
                          f"output_dir={root}/saved"), env={"LPT_FAULT_PLAN": die})
    out = {"straight_rc": [r[0] for r in finish(straight)],
           "saved_rc": [r[0] for r in finish(saved)]}
    legs = {"pp2xdp2": (4, []), "pp2xdp2-2proc": (2, []), "pp2xdp1": (2, DP1),
            "resaved": (4, ["max_steps=2", "save_final=true"])}
    procs = {}
    for name, (n, extra) in legs.items():
        shutil.copytree(root / "saved", root / name)
        extra = extra or ["max_steps=6"]
        procs[name] = launch(n, cli(*CROSS, "resume=true", *extra, f"output_dir={root}/{name}"))
    shutil.copytree(root / "saved", root / "pp1xdp1")
    one = t_train.run_training(t_config.load_config(TINY_SMOKE, CROSS + DP1 + [
        "mesh.pp=1", "max_steps=6", "resume=true", f"output_dir={root}/pp1xdp1"]), device="cpu")
    for name, ps in procs.items():
        res = finish(ps)
        assert [r[0] for r in res] == [0] * len(ps), [r[2][-2000:] for r in res]
        out[name] = res
    out["pp1xdp1"] = one
    return root, out


def test_commit_die_leaves_no_complete_checkpoint_and_resume_takes_the_previous(cross):
    """A `ckpt_commit` die at step 4 (after every process's tensors are
    durable, before meta.json) kills all four processes and leaves
    checkpoint-4 without meta.json; latest_step() is 2, which each resume
    takes."""
    root, out = cross
    assert out["straight_rc"] == [0, 0, 0, 0]
    assert all(rc != 0 for rc in out["saved_rc"]), out["saved_rc"]
    assert os.path.isdir(root / "saved" / "checkpoint-4")
    assert not os.path.exists(root / "saved" / "checkpoint-4" / "meta.json")
    assert t_ckpt.CheckpointManager(str(root / "saved")).latest_step() == 2
    assert out["pp1xdp1"]["start_step"] == 2


@pytest.mark.parametrize("leg", ["pp2xdp2", "pp2xdp2-2proc", "pp2xdp1", "pp1xdp1"])
def test_checkpoint_of_four_processes_resumes_in_four_two_and_one(cross, leg):
    """The pp 2 x dp 2 checkpoint at step 2 resumed at pp 2 x dp 2 (4
    processes, and 2 with every stage in each: its ZeRO-1 slices and the
    replicas' collectives over the local transport), pp 2 x dp 1 (2) and
    pp 1 x dp 1 (1) with the same global
    batch: the losses of steps 3-6 those of the uninterrupted run within
    1e-5, and the resume logged as the O(1) data position of step 2."""
    root, _ = cross
    straight = _metric_losses(root / "straight", range(1, 7))
    got = _metric_losses(root / leg, range(3, 7))
    np.testing.assert_allclose(got, straight[2:], rtol=1e-5, atol=1e-5)


def test_restore_then_save_at_once_is_byte_equal(cross):
    """checkpoint-2 restored by four processes (each its stage's rows and its
    ZeRO-1 slices) and saved again at once (process 0 writing every
    process's pieces): every
    tensor of params.safetensors and opt.safetensors byte-equal."""
    root, _ = cross
    for name in ("params.safetensors", "opt.safetensors"):
        a = tensor_io_load(root / "saved" / "checkpoint-2" / name)
        b = tensor_io_load(root / "resaved" / "checkpoint-2" / name)
        assert set(a) == set(b) and len(a) > 1
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)


def tensor_io_load(path):
    from llama_pipeline_parallel_tpu_torch.ckpt import tensor_io

    return tensor_io.load_file(str(path))


def test_topology_meta_across_processes_equals_reference(ref, cross):
    """meta.json's topology of the pp 2 x dp 2 save has the reference's keys
    and values for that layout (`_topology_meta` on MeshConfig(pp=2, dp=2)
    over the virtual mesh), the process count being the four processes'."""
    root, _ = cross
    meta = json.load(open(root / "saved" / "checkpoint-2" / "meta.json"))
    cfg = t_config.load_config(TINY_SMOKE, CROSS)
    mesh_cfg = ref.mesh.MeshConfig(pp=2, dp=2)
    rmodel = ref.train.build_model_config(cfg["model"])
    rman = ref.train.build_manifest(cfg, rmodel, 2)
    pcfg = ref.train.build_pipeline_config(cfg, mesh_cfg, rman)
    want = ref.train._topology_meta(ref.mesh.make_mesh(mesh_cfg), pcfg, rman)
    got = dict(meta["topology"])
    assert set(got) == set(want)
    assert got.pop("process_count") == 4 and want.pop("process_count") == 1
    assert got == want
    assert meta["data_state"]["global_batch_examples"] == 8


# ---------------------------------------------------------------------------
# checkpoints across pp x tp x dp (device AdamW with ZeRO-1, and the host
# optimizer's ZeRO-2 layout), through tests/torch_tp_worker.py
# ---------------------------------------------------------------------------

TP_CROSS = CROSS + ["mesh.tp=2"]
TP_OPTIMIZERS = {"zero1": [], "zero2": ["optimizer_offload=true",
                                        "optimizer_offload_zero2=true"]}


@pytest.fixture(scope="module")
def tp_cross(tmp_path_factory):
    """For each optimizer (TP_OPTIMIZERS), in one launch of 8 processes at
    pp 2 x tp 2 x dp 2: 4 steps saving at 2 ("straight"), then from copies
    of its checkpoint-2: a resume to step 4 in the same 8 ("pp2xtp2xdp2")
    and a resume that saves step 2 again at once ("resaved", into
    "resaved_again"). Then, from
    more copies: the ZeRO-1 checkpoint resumed at pp 2 x dp 1 (2
    processes), and both resumed in this process at pp 1 x dp 1. Returns
    the root and each run's losses."""
    import shutil
    import sys

    from tests.test_torch_dp import finish, launch

    root = tmp_path_factory.mktemp("tp_cross")
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)), "torch_tp_worker.py")
    torch.save({}, root / "inputs.pt")
    jobs = []
    for opt, keys in TP_OPTIMIZERS.items():
        d = root / opt

        def job(kind, name, *extra):
            return dict(kind=kind, name=f"{opt}-{name}", config=TINY_SMOKE,
                        overrides=TP_CROSS + keys + list(extra))

        jobs += [job("train", "straight", "max_steps=4", "save_steps=2", "resume=false",
                     f"output_dir={d}/straight"),
                 dict(kind="copy", name=f"{opt}-copy", pairs=[
                     (str(d / "straight" / "checkpoint-2"), str(d / leg / "checkpoint-2"))
                     for leg in ("pp2xtp2xdp2", "resaved", "pp2xdp1", "pp1xdp1")]),
                 job("train", "pp2xtp2xdp2", "max_steps=4", "resume=true",
                     f"output_dir={d}/pp2xtp2xdp2"),
                 dict(job("resave", "resaved", "resume=true", f"output_dir={d}/resaved"),
                      save_dir=str(d / "resaved_again"))]
    torch.save(jobs, root / "jobs.pt")
    for rc, _, stderr in finish(launch(8, [sys.executable, worker, str(root)])):
        assert rc == 0, stderr[-3000:]
    out = {f"{opt}-{leg}": torch.load(root / f"{opt}-{leg}-rank0.pt")["losses"]
           for opt in TP_OPTIMIZERS for leg in ("straight", "pp2xtp2xdp2")}
    two = root / "two"
    two.mkdir()
    torch.save({}, two / "inputs.pt")
    torch.save([dict(kind="train", name="pp2xdp1", config=TINY_SMOKE,
                     overrides=CROSS + DP1 + ["max_steps=4", "resume=true",
                                              f"output_dir={root}/zero1/pp2xdp1"])],
               two / "jobs.pt")
    procs = launch(2, [sys.executable, worker, str(two)])
    for opt, keys in TP_OPTIMIZERS.items():
        (root / opt / "pp1xdp1" / "latest").write_text("checkpoint-2")
        one = t_train.run_training(t_config.load_config(TINY_SMOKE, CROSS + DP1 + keys + [
            "mesh.pp=1", "max_steps=4", "resume=true", f"output_dir={root}/{opt}/pp1xdp1"]),
            device="cpu")
        out[f"{opt}-pp1xdp1"] = one["losses"]
    for rc, _, stderr in finish(procs):
        assert rc == 0, stderr[-3000:]
    out["zero1-pp2xdp1"] = torch.load(two / "pp2xdp1-rank0.pt")["losses"]
    return root, out


@pytest.mark.parametrize("leg", ["zero1-pp2xtp2xdp2", "zero1-pp2xdp1", "zero1-pp1xdp1",
                                 "zero2-pp2xtp2xdp2", "zero2-pp1xdp1"])
def test_tp_checkpoint_resumes_across_layouts(tp_cross, leg):
    """A pp 2 x tp 2 x dp 2 checkpoint at step 2 (8 processes: each its
    stage's rows, tp slices and ZeRO-1 moment slices, or its host ZeRO-2
    slices of the masters and moments) resumed in 8 processes, at pp 2 x
    dp 1 (2) and in one process, on the same global batch: steps 3-4 within
    1e-5 of the uninterrupted run's."""
    _, out = tp_cross
    straight = out[leg.split("-")[0] + "-straight"]
    assert len(straight) == 4 and len(out[leg]) == 2
    np.testing.assert_allclose(out[leg], straight[2:], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("opt", list(TP_OPTIMIZERS))
def test_tp_restore_then_save_at_once_is_byte_equal(tp_cross, opt):
    """checkpoint-2 of 8 processes restored by 8 (each cutting its rows, tp
    slice and dp slice out of the canonical tree) and saved again at once
    (process 0 joining every process's pieces): every tensor of every file
    byte-equal, the host optimizer's offload_parts files included."""
    root, _ = tp_cross
    files = (("params.safetensors", "opt.safetensors") if opt == "zero1" else
             ("params.safetensors", "opt_m.safetensors", "opt_v.safetensors"))
    for name in files:
        a = tensor_io_load(root / opt / "straight" / "checkpoint-2" / name)
        b = tensor_io_load(root / opt / "resaved_again" / "checkpoint-2" / name)
        assert set(a) == set(b) and len(a) > 1
        for k in a:
            assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), (name, k)
    meta = json.load(open(root / opt / "resaved_again" / "checkpoint-2" / "meta.json"))
    assert (meta.get("opt_layout") == "offload_parts") == (opt == "zero2")


def test_tp_topology_meta_equals_reference(ref, tp_cross):
    """meta.json's topology of the pp 2 x tp 2 x dp 2 save has the
    reference's keys and values for that layout (`_topology_meta` over the
    virtual mesh), the process count being the eight processes'."""
    root, _ = tp_cross
    meta = json.load(open(root / "zero1" / "straight" / "checkpoint-2" / "meta.json"))
    cfg = t_config.load_config(TINY_SMOKE, TP_CROSS)
    mesh_cfg = ref.mesh.MeshConfig(pp=2, dp=2, tp=2)
    rmodel = ref.train.build_model_config(cfg["model"])
    rman = ref.train.build_manifest(cfg, rmodel, 2)
    pcfg = ref.train.build_pipeline_config(cfg, mesh_cfg, rman)
    want = ref.train._topology_meta(ref.mesh.make_mesh(mesh_cfg), pcfg, rman)
    got = dict(meta["topology"])
    assert set(got) == set(want)
    assert got.pop("process_count") == 8 and want.pop("process_count") == 1
    assert got == want and got["tp"] == 2 and got["layout"] == "pp2xdp2xtp2xsp1"
