"""The port's host tiers of the pipeline (utils/host_stash.py and the
interpreter's offload.wgrad_stash / offload.activations / offloaded solver
units) against the same runs with the tiers off and against the JAX
package's pipeline with its offload knobs, on the CPU at the `tiny` preset in
fp32.

On the CPU the tiers are identity copies into ordinary host rings (the mode
the reference's `supports_host_memory()` gate picks on XLA-CPU), so the
interpreter's push, pop and prefetch logic runs here as on the card. The
copies move bytes: with a tier on, the loss and every gradient are bit-equal
to the run with it off. Against the reference: the loss within rtol 1e-5,
each gradient leaf within 1e-4 of its largest element (the limits of
tests/test_torch_pipeline.py). The pinned round trip and the W drain's
prefetch order on real streams need the card (`cuda`).
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import train as t_train
from llama_pipeline_parallel_tpu_torch.data.collator import IGNORE_INDEX
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.models.llama import model as t_llama
from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest as TManifest
from llama_pipeline_parallel_tpu_torch.ops.attention import attention as t_attention
from llama_pipeline_parallel_tpu_torch.parallel import pipeline as t_pl
from llama_pipeline_parallel_tpu_torch.parallel import schedule as t_us
from llama_pipeline_parallel_tpu_torch.parallel.mesh import MeshConfig, make_mesh
from llama_pipeline_parallel_tpu_torch.utils import host_stash

LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4
# the reference's mixed offload vector (tests/test_unit_schedule.py)
MIXED = [True, False, True, False, False, True, False, True]


@pytest.fixture(scope="module")
def ref():
    """The reference modules, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (imported by the reference's host stash; its transfers stay gated off
    on the CPU, so it is never constructed)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    mods = {"llama": "models.llama.model", "config": "models.llama.config",
            "manifest": "models.llama.manifest", "pl": "parallel.pipeline",
            "mesh": "parallel.mesh", "attn": "ops.attention", "us": "parallel.schedule",
            "train": "train"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


@pytest.fixture(scope="module")
def tree(ref):
    return jax.device_get(ref.llama.init_params(jax.random.PRNGKey(0),
                                                ref.config.LlamaConfig.tiny()))


def _batch(b=8, s=16, seed=3, vocab=256):
    """Rows of random tokens with a pad tail and two ignored leading labels."""
    rng = np.random.RandomState(seed)
    ids = rng.randint(3, vocab, size=(b, s)).astype(np.int32)
    mask = np.ones((b, s), np.int32)
    mask[:, -3:] = 0
    labels = np.where(mask != 0, ids, IGNORE_INDEX).astype(np.int32)
    labels[:, :2] = IGNORE_INDEX
    pos = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s)).copy()
    return {"input_ids": ids, "attention_mask": mask, "position_ids": pos, "labels": labels}


def _port(tree, pp, m, **knobs):
    """(loss, canonical gradients, the pipeline) of one step of the port's
    in-process pipeline from the reference's params."""
    cfg = TConfig.tiny()
    v = knobs.get("virtual_stages", 1)
    manifest = TManifest(num_layers=cfg.num_hidden_layers, num_stages=pp, virtual_stages=v)
    pcfg = t_pl.PipelineConfig(num_stages=pp, num_microbatches=m, remat=True, **knobs)
    sp = t_pl.StageParams.from_canonical(convert.params_from_jax(tree), manifest)
    pipe = t_pl.Pipeline(cfg, pcfg, make_mesh(MeshConfig(pp=pp)), sp, t_attention)
    loss = pipe.loss_and_grad({k: torch.from_numpy(x) for k, x in _batch().items()})
    return loss.item(), sp.to_canonical(sp.grads()), pipe


def _ref(ref, tree, pp, m, **knobs):
    """The reference's loss and canonical gradients. Its tiers run with
    LPT_HOST_STASH_FORCE=0, the reference's switch for its CPU mode (the
    stores stay in regular memory, the same program otherwise): this jax's
    CPU devices list a pinned_host memory, which the reference would
    otherwise target through the TransferToMemoryKind stand-in."""
    cfg = ref.config.LlamaConfig.tiny()
    v = knobs.get("virtual_stages", 1)
    manifest = ref.manifest.StageManifest(num_layers=cfg.num_hidden_layers, num_stages=pp,
                                          virtual_stages=v)
    pcfg = ref.pl.PipelineConfig(num_stages=pp, num_microbatches=m, remat=True, **knobs)
    mesh = ref.mesh.make_mesh(ref.mesh.MeshConfig(pp=pp, dp=1))
    stacked = ref.pl.stack_stages(tree, manifest)
    fn = jax.jit(ref.pl.make_pipeline_loss_and_grad(mesh, cfg, pcfg, stacked,
                                                    attn_fn=ref.attn.attention))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("LPT_HOST_STASH_FORCE", "0")
        loss, grads = fn(stacked, {k: jnp.asarray(x) for k, x in _batch().items()})
    canonical = convert.unstack_stages(jax.device_get(grads), TManifest(
        num_layers=cfg.num_hidden_layers, num_stages=pp, virtual_stages=v))
    return float(loss), convert.params_from_jax(canonical)


def _assert_bit_equal(a, b):
    assert a[0] == b[0]
    assert set(a[1]) == set(b[1])
    for k in a[1]:
        assert torch.equal(a[1][k], b[1][k]), k


def _assert_close(got, want):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL)
    for k, w in want[1].items():
        scale = max(float(w.abs().max()), 1e-30)
        assert float((got[1][k] - w).abs().max()) <= GRAD_RTOL * scale, k


TIER_CASES = {
    "zb1-v2-wgrad-and-activations": (dict(schedule="zb1", virtual_stages=2),
                                     dict(offload_wgrad=True, offload_activations=True)),
    "1f1b-activations": (dict(schedule="1f1b"), dict(offload_activations=True)),
}


@pytest.mark.parametrize("name", list(TIER_CASES))
def test_tiers_bit_equal_to_off_and_match_reference(ref, tree, name):
    """One step with the tiers on: loss and gradients bit-equal to the same
    schedule with them off, the host rings in use (the byte model's bytes
    on each stage that stores something: under flat 1f1b stage 0's inputs
    are embedding lookups, which nothing buffers), and both within the
    limits of the reference pipeline with its offload knobs."""
    sched, tiers = TIER_CASES[name]
    off = _port(tree, 2, 4, **sched)
    on = _port(tree, 2, 4, **sched, **tiers)
    _assert_bit_equal(on[:2], off[:2])
    pipe = on[2]
    per_stage = t_pl.host_stash_bytes(pipe.pcfg, *t_pl.stash_dims(2, 16, 1, 64, torch.float32))
    storing = 2 if sched.get("virtual_stages", 1) > 1 else 1
    assert pipe.host_stash_bytes() == storing * per_stage > 0
    if tiers.get("offload_wgrad"):
        assert [e for e in pipe.stash_trace if e[0] == "push"]
    _assert_close(on[:2], _ref(ref, tree, 2, 4, **sched, **tiers))


def test_solver_sequence_with_offloaded_units_matches_all_hbm(ref, tree, tmp_path):
    """A solver sequence (canonical zb1 placement, the reference's mixed
    per-unit offload vector, written by the reference's to_json and loaded
    here) runs, and its loss and gradients are bit-equal to the same
    sequence with no unit offloaded and to flat 1f1b (the fold order is the
    same); only the offloaded units pass through the host rings."""
    seq = ref.us.with_offload(ref.us.canonical_schedule("zb1", 4, 2, 2), np.array(MIXED))
    path = tmp_path / "unit_schedule.json"
    path.write_text(ref.us.to_json(seq))
    loaded = t_us.load(str(path))
    assert loaded.offloaded_units == sum(MIXED)
    mixed = _port(tree, 2, 4, schedule="solver", virtual_stages=2, unit_schedule=loaded)
    hbm = _port(tree, 2, 4, schedule="solver", virtual_stages=2,
                unit_schedule=t_us.with_offload(loaded, np.zeros(8, bool)))
    flat = _port(tree, 2, 4, schedule="1f1b")
    _assert_bit_equal(mixed[:2], hbm[:2])
    _assert_bit_equal(mixed[:2], flat[:2])
    pushed = {(s, g) for kind, s, g in mixed[2].stash_trace if kind == "push"}
    assert {g for _, g in pushed} == {g for g, hosted in enumerate(MIXED) if hosted}
    assert hbm[2].stash_trace == []


def test_w_drain_prefetches_one_unit_ahead(tree):
    """Each stage's W drain takes its next unit's pair off the host ring
    before the current unit replays: per stage, pop(g1) comes before
    replay(g0) for consecutive W units g0, g1, and every pushed unit is
    popped once and replayed once."""
    pipe = _port(tree, 2, 4, schedule="zb1", virtual_stages=2, offload_wgrad=True)[2]
    trace = pipe.stash_trace
    for s in (0, 1):
        events = [(kind, g) for kind, st, g in trace if st == s]
        replays = [g for kind, g in events if kind == "replay"]
        pops = [g for kind, g in events if kind == "pop"]
        assert sorted(pops) == sorted(replays) == sorted(g for kind, g in events
                                                          if kind == "push")
        for g0, g1 in zip(replays, replays[1:]):
            assert events.index(("pop", g1)) < events.index(("replay", g0))


CONFIGS = {
    "zb1-wgrad": dict(schedule="zb1", num_stages=8, num_microbatches=256, virtual_stages=2,
                      offload_wgrad=True),
    "zb1-both": dict(schedule="zb1", num_stages=8, num_microbatches=256, virtual_stages=2,
                     offload_wgrad=True, offload_activations=True),
    "zb1-off": dict(schedule="zb1", num_stages=2, num_microbatches=4, virtual_stages=2),
    "1f1b-activations": dict(schedule="1f1b", num_stages=4, num_microbatches=16,
                             offload_activations=True),
    "interleaved-activations-chunks": dict(schedule="interleaved_1f1b", num_stages=2,
                                           num_microbatches=8, virtual_stages=2,
                                           accum_chunks=2, offload_activations=True),
    "1f1b-one-stage-activations": dict(schedule="1f1b", num_stages=1, num_microbatches=8,
                                       offload_activations=True),
    "solver-mixed": dict(schedule="solver", num_stages=2, num_microbatches=4,
                         virtual_stages=2),
}


@pytest.mark.parametrize("name", list(CONFIGS))
def test_byte_models_and_metrics_keys_match_reference(ref, name):
    """wgrad_partition, wgrad_queue_peak, wgrad_offloaded_units, the stash,
    ring and host byte models, stash_dims and the metrics line's host-stash
    keys (`_offload_static`) equal the reference's on the same config."""
    kw = dict(CONFIGS[name])
    if kw["schedule"] == "solver":
        seq_j = ref.us.with_offload(ref.us.canonical_schedule("zb1", 4, 2, 2), np.array(MIXED))
        seq_t = t_us.with_offload(t_us.canonical_schedule("zb1", 4, 2, 2), np.array(MIXED))
        mine = t_pl.PipelineConfig(unit_schedule=seq_t, **kw)
        theirs = ref.pl.PipelineConfig(unit_schedule=seq_j, **kw)
    else:
        mine, theirs = t_pl.PipelineConfig(**kw), ref.pl.PipelineConfig(**kw)
    dims = (2, 512, 64, 2)
    assert t_pl.wgrad_partition(mine) == ref.pl.wgrad_partition(theirs)
    assert t_pl.wgrad_queue_peak(mine) == ref.pl.wgrad_queue_peak(theirs)
    assert t_pl.wgrad_offloaded_units(mine) == ref.pl.wgrad_offloaded_units(theirs)
    assert t_pl.activation_ring_slots(mine) == ref.pl.activation_ring_slots(theirs)
    for fn in ("wgrad_stash_bytes", "activation_ring_bytes", "host_stash_bytes"):
        assert getattr(t_pl, fn)(mine, *dims) == getattr(ref.pl, fn)(theirs, *dims), fn
    assert t_pl.stash_dims(2, 512, 2, 64, torch.bfloat16) == ref.pl.stash_dims(
        2, 512, 2, 64, jnp.bfloat16)
    assert t_train._offload_static(mine, *dims) == ref.train._offload_static(theirs, *dims)


@pytest.mark.parametrize("knobs,match", [
    (dict(schedule="1f1b", offload_wgrad=True), "zb1"),
    (dict(schedule="interleaved_1f1b", virtual_stages=2, offload_wgrad=True), "zb1"),
    (dict(schedule="gpipe", offload_activations=True), "gpipe"),
])
def test_pipeline_config_refuses_tiers_as_reference(ref, knobs, match):
    """offload.wgrad_stash needs zb1 and offload.activations refuses gpipe,
    with the reference's ValueError."""
    for pl in (t_pl, ref.pl):
        with pytest.raises(ValueError, match=match):
            pl.PipelineConfig(num_stages=2, num_microbatches=4, **knobs)


def test_solver_sequence_refuses_the_boolean(ref):
    seq = t_us.canonical_schedule("zb1", 4, 2, 2)
    with pytest.raises(ValueError, match="per-unit offload"):
        t_pl.PipelineConfig(num_stages=2, num_microbatches=4, schedule="solver",
                            virtual_stages=2, unit_schedule=seq, offload_wgrad=True)


def test_offload_block_reaches_the_pipeline_config():
    """`offload.*` parses as the reference's `_offload_flags` and lands in the
    run's PipelineConfig; unknown keys are refused."""
    assert t_train._offload_flags({}) == (False, False)
    assert t_train._offload_flags({"offload": {"activations": True}}) == (False, True)
    with pytest.raises(ValueError, match="unknown offload"):
        t_train._offload_flags({"offload": {"wgrad": True}})
    cfg = TConfig.tiny(num_hidden_layers=8)
    raw = {"pipeline_schedule": "zb1", "virtual_stages": 2, "gradient_accumulation_steps": 2,
           "offload": {"wgrad_stash": True, "activations": True}}
    pcfg = t_train.build_pipeline_config(raw, MeshConfig(pp=2),
                                         t_train.build_manifest(raw, cfg, 2))
    assert pcfg.offload_wgrad and pcfg.offload_activations


def test_stash_push_pop_and_the_garbage_slot():
    """A push lands in its slot; an invalid push lands in the garbage slot
    and leaves the live slots alone; a pop is a copy (a later push to the
    slot does not change it); a slot outside the ring is refused."""
    buf = host_stash.stash_init(3, (4,), torch.float32, "cpu")
    v = torch.arange(4.0)
    host_stash.stash_push(buf, v, 1)
    host_stash.stash_push(buf, v * 9, 2, valid=False)
    got = host_stash.ready(host_stash.stash_pop(buf, 1, "cpu"))
    host_stash.stash_push(buf, v * 5, 1)
    assert buf.shape == (4, 4)
    assert torch.equal(got, v)
    assert torch.equal(buf[2], torch.zeros(4)) and torch.equal(buf[3], v * 9)
    with pytest.raises(IndexError):
        host_stash.stash_push(buf, v, 3)


def test_transfers_follow_the_device():
    """Real transfers exactly on cuda; on the CPU to_host / to_device are
    identities and the link probe reads memcpy."""
    assert host_stash.transfers_enabled("cuda") and not host_stash.transfers_enabled("cpu")
    t = torch.ones(3)
    assert host_stash.to_host(t) is t
    assert host_stash.ready(host_stash.to_device(t, "cpu")) is t
    bw = host_stash.measure_transfer_bandwidth(nbytes=1 << 16, reps=1, device="cpu")
    assert bw["h2d_gbps"] > 0 and bw["d2h_gbps"] > 0 and bw["pinned_host"] is False


@pytest.mark.cuda
def test_pinned_round_trip_on_card():
    """On the card a ring is pinned host memory, a push copies on the side
    stream, a pop comes back bit-equal, and the link probe reads both ways."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.randn(4, 64, 128, device="cuda").to(torch.bfloat16)
    buf = host_stash.stash_init(2, x.shape, x.dtype, "cuda")
    assert buf.is_pinned() and buf.device.type == "cpu"
    host_stash.stash_push(buf, x * 2, 1)
    back = host_stash.ready(host_stash.stash_pop(buf, 1, "cuda"))
    assert back.is_cuda and torch.equal(back, x * 2)
    bw = host_stash.measure_transfer_bandwidth(nbytes=1 << 24, reps=2)
    assert bw["pinned_host"] and bw["h2d_gbps"] > 1 and bw["d2h_gbps"] > 1


@pytest.mark.cuda
def test_w_drain_prefetch_order_on_card():
    """zb1 with the W queue in pinned host memory on the card: the drain's
    pops run one unit ahead of the replays, and the step's loss and
    gradients are bit-equal to the queue kept on the card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    cfg = TConfig.tiny()
    manifest = TManifest(num_layers=cfg.num_hidden_layers, num_stages=2, virtual_stages=2)
    params = {k: v.cuda() for k, v in t_llama.init_params(cfg, device="cpu").items()}
    batch = {k: torch.from_numpy(x).cuda() for k, x in _batch().items()}
    runs = []
    for offload in (False, True):
        pcfg = t_pl.PipelineConfig(num_stages=2, num_microbatches=4, schedule="zb1",
                                   virtual_stages=2, offload_wgrad=offload)
        sp = t_pl.StageParams.from_canonical(params, manifest)
        pipe = t_pl.Pipeline(cfg, pcfg, make_mesh(MeshConfig(pp=2)), sp, t_attention)
        runs.append((pipe.loss_and_grad(batch).item(), sp.to_canonical(sp.grads()), pipe))
    _assert_bit_equal(runs[1][:2], runs[0][:2])
    trace = runs[1][2].stash_trace
    for s in (0, 1):
        events = [(kind, g) for kind, st, g in trace if st == s]
        replays = [g for kind, g in events if kind == "replay"]
        for g0, g1 in zip(replays, replays[1:]):
            assert events.index(("pop", g1)) < events.index(("replay", g0))
