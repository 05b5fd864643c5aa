"""The port's serving (serve/, tools/{generate,serve_traffic,serving_report,
request_report}) against the JAX package's, on the CPU at the `tiny`
preset in fp32, parameters carried across with `convert.params_from_jax`.

Limits:
- greedy served tokens of the port's dense and paged engines equal the JAX
  ServeEngine's on the same staggered requests;
- the port's own contracts hold exactly: served = `generate` (sampled too,
  one generator a request), paged = dense, int8's first token = fp's,
  prefix hit = cold, chunked = whole;
- the refusals (ServeOverloaded, ServePagesExhausted with retry_after_s),
  cancellation (slot and pages freed), `metrics_snapshot`'s keys and the
  span names are the reference's;
- the telemetry and reqtrace copies give the reference's outputs on the
  same inputs;
- the HTTP frontend streams the engine's tokens and maps overload to 429
  with Retry-After;
- the tools on a checkpoint and a tokenizer made here: generate decodes
  the reference's greedy tokens; serving_report and request_report print
  the reference tools' text on the same run directory (the one line that
  names the tool to run next names the port's).
"""

import json
import threading
import types
import urllib.error
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch import serve as ts
from llama_pipeline_parallel_tpu_torch.models.llama import decode as td
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig
from llama_pipeline_parallel_tpu_torch.serve import reqtrace as t_reqtrace
from llama_pipeline_parallel_tpu_torch.serve import telemetry as t_tel

BUCKET = 8
PAGE = 4


@pytest.fixture(scope="module")
def ref():
    """The reference modules, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    from llama_pipeline_parallel_tpu import serve
    from llama_pipeline_parallel_tpu.models.llama import decode, model
    from llama_pipeline_parallel_tpu.models.llama.config import LlamaConfig
    from llama_pipeline_parallel_tpu.serve import reqtrace, telemetry
    from llama_pipeline_parallel_tpu.utils import trace

    return types.SimpleNamespace(serve=serve, decode=decode, llama=model, LlamaConfig=LlamaConfig,
                                 reqtrace=reqtrace, telemetry=telemetry, trace=trace)


@pytest.fixture(scope="module")
def setup(ref):
    jcfg = ref.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = TConfig.tiny(dtype=torch.float32)
    jp = ref.llama.init_params(jax.random.PRNGKey(0), jcfg)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=convert.params_from_jax(jp))


def config(mod, **kw):
    base = dict(max_slots=2, max_len=BUCKET + 8, prompt_buckets=(BUCKET,), max_queue=8,
                metrics_every=1, decode_span_every=1)
    base.update(kw)
    return mod.ServeConfig(**base)


def port_engine(s, **kw):
    return ts.ServeEngine(s.tp, s.tcfg, config(ts, **kw), device="cpu")


def requests(vocab, gens, seed=0, lengths=(5, 8, 3, 7)):
    rs = np.random.RandomState(seed)
    return [(rs.randint(3, vocab, n).tolist(), g, i)
            for i, (n, g) in enumerate(zip(lengths, gens))]


def serve(mod, engine, reqs, stagger=True):
    """Two requests up front, two steps, the rest (they join the running
    batch at a later boundary), drain; the streams in request order."""
    first = reqs[:2] if stagger else reqs
    handles = [engine.submit(mod.ServeRequest(input_ids=p, gen=g, seed=sd))
               for p, g, sd in first]
    if stagger:
        engine.step()
        engine.step()
        handles += [engine.submit(mod.ServeRequest(input_ids=p, gen=g, seed=sd))
                    for p, g, sd in reqs[2:]]
    engine.drain(timeout_s=120)
    return [h.result(timeout=1) for h in handles]


def generate_tokens(s, prompt, gen, seed, bucket=BUCKET):
    """The port's generate on the prompt left-padded to `bucket`."""
    pad = bucket - len(prompt)
    ids = np.asarray([[0] * pad + prompt])
    mask = np.asarray([[0] * pad + [1] * len(prompt)])
    out = td.generate(td.compute_params(s.tp, s.tcfg), ids, mask, s.tcfg, gen,
                      generator=torch.Generator().manual_seed(seed))
    return out["tokens"][0].tolist()


GREEDY = [td.GenerationConfig(max_new_tokens=n) for n in (6, 4, 6, 5)]
SAMPLED = [td.GenerationConfig(max_new_tokens=6),
           td.GenerationConfig(max_new_tokens=4, temperature=0.8, top_k=5),
           td.GenerationConfig(max_new_tokens=6, temperature=0.7, top_p=0.9),
           td.GenerationConfig(max_new_tokens=5, temperature=1.1)]
PAGED = dict(kv_cache="paged", page_size=PAGE, num_pages=16)


@pytest.fixture(scope="module")
def reference_greedy(ref, setup):
    """The JAX ServeEngine's greedy streams on the staggered requests."""
    s = setup
    gens = [ref.decode.GenerationConfig(max_new_tokens=g.max_new_tokens) for g in GREEDY]
    engine = ref.serve.ServeEngine(s.jp, s.jcfg, config(ref.serve))
    return serve(ref.serve, engine, requests(s.tcfg.vocab_size, gens))


@pytest.mark.parametrize("kw", [{}, PAGED, dict(PAGED, prefill_chunk_tokens=PAGE)],
                         ids=["dense", "paged", "paged-chunked"])
def test_greedy_streams_equal_reference_engine(setup, reference_greedy, kw):
    s = setup
    got = serve(ts, port_engine(s, **kw), requests(s.tcfg.vocab_size, GREEDY))
    assert got == reference_greedy


@pytest.mark.parametrize("kw", [{}, PAGED], ids=["dense", "paged"])
def test_served_equals_generate_sampled_too(setup, kw):
    """Every request's stream is the port's generate on its padded prompt
    with a generator seeded by its seed; one cache allocation serves them
    all and every slot and page comes back."""
    s = setup
    reqs = requests(s.tcfg.vocab_size, SAMPLED)
    engine = port_engine(s, **kw)
    got = serve(ts, engine, reqs)
    for (prompt, gen, seed), toks in zip(reqs, got):
        assert toks == generate_tokens(s, prompt, gen, seed)
    assert engine.slots.allocations == 1 and engine.slots.reused_slot_count() >= 1
    assert engine.slots.free_count == 2
    if kw:
        assert engine.slots.pages_free == engine.slots.num_pages
        assert engine.slots.pages_reserved == 0


def test_paged_int8_chunked_and_order_contracts(setup):
    """paged = dense on the same requests in another order (a request's
    tokens depend on its seed only); chunked = whole; int8's first token =
    fp's."""
    s = setup
    reqs = requests(s.tcfg.vocab_size, SAMPLED, seed=1, lengths=(8, 2, 6, 4))
    dense = serve(ts, port_engine(s), reqs)
    rev = serve(ts, port_engine(s, **PAGED), reqs[::-1])[::-1]
    assert rev == dense
    long = dict(PAGED, max_len=32, prompt_buckets=(16,), num_pages=32)
    chunked = serve(ts, port_engine(s, prefill_chunk_tokens=8, **long), reqs)
    whole = serve(ts, port_engine(s, **long), reqs)
    assert chunked == whole
    q = serve(ts, port_engine(s, kv_quant="int8", **PAGED), reqs)
    assert [t[0] for t in q] == [t[0] for t in dense]
    assert [len(t) for t in q] == [g.max_new_tokens for _, g, _ in reqs]


def test_prefix_hit_equals_cold(setup):
    """Requests sharing a padded prefix with an earlier one map its pages
    (full pages and a copy-on-write fork) and recompute only their tails,
    and stream what a cold engine streams."""
    s = setup
    rs = np.random.RandomState(2)
    shared = rs.randint(3, s.tcfg.vocab_size, 9).tolist()
    reqs = [(shared + rs.randint(3, s.tcfg.vocab_size, 3).tolist(), g, i)
            for i, g in enumerate(SAMPLED[:3])]
    kw = dict(PAGED, max_len=32, prompt_buckets=(16,), num_pages=32)
    cold = [serve(ts, port_engine(s, **kw), [r], stagger=False)[0] for r in reqs]
    engine = port_engine(s, prefix_cache=True, **kw)
    warm = serve(ts, engine, reqs[:1], stagger=False)
    handles = [engine.submit(ts.ServeRequest(input_ids=p, gen=g, seed=sd))
               for p, g, sd in reqs[1:]]
    engine.drain(timeout_s=60)
    warm += [h.result(timeout=1) for h in handles]
    assert all(h.prefix_cached_tokens >= 4 + 9 - 1 for h in handles)
    snap = engine.metrics_snapshot()
    assert snap["prefix_hits"] == 2 and snap["prefix_cow_forks"] >= 1
    assert warm == cold


def test_refusals_carry_retry_after(setup):
    s = setup
    engine = port_engine(s, max_queue=1)
    small = td.GenerationConfig(max_new_tokens=2)
    engine.submit(ts.ServeRequest(input_ids=[3], gen=small))
    with pytest.raises(ts.ServeOverloaded) as err:
        engine.submit(ts.ServeRequest(input_ids=[4], gen=small))
    assert err.value.retry_after_s > 0
    with pytest.raises(ts.RequestRejected):
        engine.submit(ts.ServeRequest(input_ids=list(range(BUCKET + 1)), gen=small))
    paged = port_engine(s, kv_cache="paged", page_size=PAGE, num_pages=4)
    paged.submit(ts.ServeRequest(input_ids=[3, 4], gen=td.GenerationConfig(max_new_tokens=8)))
    with pytest.raises(ts.ServePagesExhausted) as err:
        paged.submit(ts.ServeRequest(input_ids=[5], gen=td.GenerationConfig(max_new_tokens=8)))
    assert err.value.retry_after_s > 0
    snap = paged.metrics_snapshot()
    assert snap["requests_page_refused"] == 1 and snap["requests_rejected"] == 1
    paged.drain(timeout_s=60)
    assert paged.slots.pages_reserved == 0


def test_cancelled_request_frees_slot_and_pages(setup):
    """An abandoned request, queued or decoding, is cancelled at the next
    boundary: its slot, pages and reservation come back and its stream
    ends; the other request still gets its generate() tokens."""
    s = setup
    engine = port_engine(s, max_slots=1, **PAGED)
    gen = td.GenerationConfig(max_new_tokens=8)
    a = ts.ServeRequest(input_ids=[5, 6, 7], gen=gen, seed=0)
    b = ts.ServeRequest(input_ids=[8, 9], gen=gen, seed=1)
    ha, hb = engine.submit(a), engine.submit(b)
    engine.step()
    assert engine.slots.active_count == 1 and len(ha.tokens_out) == 2
    engine.note_abandoned(a)
    engine.step()
    assert ha.done and len(ha.tokens_out) < 8
    engine.drain(timeout_s=60)
    assert hb.result(timeout=1) == generate_tokens(s, [8, 9], gen, 1)
    assert engine.slots.free_count == 1
    assert engine.slots.pages_free == engine.slots.num_pages
    assert engine.slots.pages_reserved == 0
    snap = engine.metrics_snapshot()
    assert snap["requests_abandoned"] == 1 and snap["requests_completed"] == 1


def test_engine_refuses_a_missing_card(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA device"):
        ts.ServeEngine(setup.tp, setup.tcfg, config(ts))


def _spans_and_snapshot(mod, trace_mod, engine_fn, reqs, tmp):
    trace_mod.configure(str(tmp))
    try:
        engine = engine_fn()
        serve(mod, engine, reqs)
        engine.shutdown()
        snap = engine.metrics_snapshot()
    finally:
        trace_mod.configure(None)
    with open(tmp / "spans.jsonl") as f:
        spans = [json.loads(line) for line in f]
    return spans, snap


@pytest.mark.parametrize("kw", [{}, dict(PAGED, prefix_cache=True)], ids=["dense", "paged"])
def test_snapshot_keys_and_span_names_equal_reference(ref, setup, tmp_path, kw):
    from llama_pipeline_parallel_tpu_torch.utils import trace as t_trace

    s = setup
    jgens = [ref.decode.GenerationConfig(max_new_tokens=g.max_new_tokens) for g in GREEDY]
    jspans, jsnap = _spans_and_snapshot(
        ref.serve, ref.trace, lambda: ref.serve.ServeEngine(s.jp, s.jcfg, config(ref.serve, **kw)),
        requests(s.tcfg.vocab_size, jgens), tmp_path / "ref")
    tspans, tsnap = _spans_and_snapshot(ts, t_trace, lambda: port_engine(s, **kw),
                                        requests(s.tcfg.vocab_size, GREEDY), tmp_path / "port")
    assert sorted(tsnap) == sorted(jsnap)
    assert sorted({x["name"] for x in tspans}) == sorted({x["name"] for x in jspans})
    for name in ("serve_request", "serve_ttft", "serve_queue_wait", "serve_prefill"):
        assert (sum(x["name"] == name for x in tspans)
                == sum(x["name"] == name for x in jspans))
    for key in ("requests_completed", "tokens_generated", "slot_allocations",
                "pages_total", "pages_used", "pages_reserved", "prefix_hits"):
        assert tsnap.get(key) == jsnap.get(key)


def test_telemetry_copy_pinned_to_reference(ref):
    """SLOStats, the percentile helpers, the thresholds and retry_after_s
    give the reference's outputs on the same records."""
    rs = np.random.RandomState(3)
    stats = {"ref": ref.telemetry.SLOStats(window=16), "port": t_tel.SLOStats(window=16)}
    for _ in range(40):
        ttft, tpot, qw = rs.rand(3)
        tenant = ["free", "paid", None][rs.randint(3)]
        tok = int(rs.randint(1, 30))
        for st in stats.values():
            st.record(ttft=ttft, tpot=tpot if tok > 1 else None, queue_wait=qw, tokens=tok,
                      tenant=tenant)
    for st in stats.values():
        st.record_rejected("free")
        st.record_failed("paid")
        st.record_abandoned(None)
        st.record_slo_breach("paid")
        st.record_prefix(12, 3, True)
        st.record_prefix(0, 0, False)
        st.record_page_refused()
    assert stats["port"].snapshot() == stats["ref"].snapshot()
    vals = rs.rand(57).tolist()
    assert t_tel.percentiles_ms(vals, "x") == ref.telemetry.percentiles_ms(vals, "x")
    for q in (0, 37, 50, 99, 100):
        assert t_tel.percentile(vals, q) == ref.telemetry.percentile(vals, q)
    for pending, rate, key in ((0, None, "a"), (7, 3.5, "req-9"), (40, 0.25, "zz")):
        assert (t_tel.retry_after_s(pending, rate, key)
                == ref.telemetry.retry_after_s(pending, rate, key))
    th = (t_tel.SLOThresholds(ttft_s=0.5, tpot_s=0.1),
          ref.telemetry.SLOThresholds(ttft_s=0.5, tpot_s=0.1))
    for args in ((0.7, 0.05, 0.1), (0.2, 0.2, 0.0), (0.1, None, 0.0)):
        assert th[0].breaches(*args) == th[1].breaches(*args)
    assert t_tel.SERVE_COUNTER_KEYS == ref.telemetry.SERVE_COUNTER_KEYS


def test_reqtrace_copy_pinned_to_reference(ref, tmp_path):
    """One request's span tree (admission, a prefix hit, two prefill chunks,
    page allocations, ticks shared with co-tenants, completion), a shed
    record and the exemplar snapshot: the same records."""
    out = {}
    for name, mod, rt in (("ref", ref.serve, ref.reqtrace), ("port", ts, t_reqtrace)):
        rec = rt.RequestTraceRecorder(str(tmp_path / name), exemplar_k=2)
        for i in range(3):
            req = mod.ServeRequest(input_ids=[1, 2], request_id=f"r{i}", arrival=100.0 + i,
                                   tenant="paid", seed=i,
                                   trace=rt.TraceContext("ab" * 16, f"{i:016x}", "cd" * 8))
            b = rec.begin(req)
            b.admitted(100.5 + i, slot=i % 2, bucket=8, pages_reserved=3)
            b.prefix_hit(4, 1, True)
            b.prefill_chunk(100.6 + i, 0.01, 0, 4, tick=1)
            b.page_alloc(1, 2)
            b.prefill_chunk(100.7 + i, 0.02, 4, 4, tick=2)
            b.first_token(100.8 + i)
            for tick in range(3, 6):
                b.decode_tick(tick, 1 + tick % 2)
            rec.write(b.build("completed", 101.0 + 0.3 * i, tokens=4, ttft=0.8,
                              tpot=0.05 * (i + 1), queue_wait=0.5))
        shed = mod.ServeRequest(input_ids=[3], request_id="shed", arrival=99.0,
                                trace=rt.TraceContext("ab" * 16, "f" * 16))
        rec.record_shed(shed, "queue_full", 1.5)
        out[name] = rec.exemplars()
        rec.close()
    assert out["port"] == out["ref"]
    lines = {n: (tmp_path / n / "request_trace.jsonl").read_text() for n in ("ref", "port")}
    strip = [{k: v for k, v in json.loads(x).items() if k != "ts_written"}
             for x in lines["ref"].splitlines()]
    assert [{k: v for k, v in json.loads(x).items() if k != "ts_written"}
            for x in lines["port"].splitlines()] == strip


def test_http_frontend_streams_and_sheds(setup):
    """POST /v1/generate streamed returns the engine's tokens line by line
    with the ids on the first line; a full queue answers 429 with
    Retry-After and the ids in the body; /healthz serves the snapshot."""
    from llama_pipeline_parallel_tpu_torch.serve.frontend import make_server

    s = setup
    engine = port_engine(s)
    server = make_server(engine)
    port = server.server_address[1]
    threading.Thread(target=server.serve_forever, daemon=True).start()

    def post(body):
        req = urllib.request.Request(f"http://127.0.0.1:{port}/v1/generate",
                                     data=json.dumps(body).encode(),
                                     headers={"Content-Type": "application/json"})
        return urllib.request.urlopen(req, timeout=60)

    try:
        gen = td.GenerationConfig(max_new_tokens=4, temperature=0.8, top_p=0.9)
        with ts.ServeLoop(engine, idle_wait_s=0.005):
            stream = post({"input_ids": [4, 5], "max_new_tokens": 4, "temperature": 0.8,
                           "top_p": 0.9, "seed": 2, "stream": True})
            lines = [json.loads(x) for x in stream.read().decode().splitlines()]
            assert [x["token"] for x in lines[:-1]] == lines[-1]["tokens"]
            assert lines[-1]["tokens"] == generate_tokens(s, [4, 5], gen, 2)
            assert lines[0]["trace_id"] == stream.headers["X-Trace-Id"]
            health = json.load(urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz",
                                                      timeout=10))
            assert health["serving"] == 1 and health["requests_completed"] == 1
        engine2 = port_engine(s, max_queue=1)
        server.engine = engine2
        engine2.submit(ts.ServeRequest(input_ids=[3], gen=td.GenerationConfig(max_new_tokens=2)))
        with pytest.raises(urllib.error.HTTPError) as err:
            post({"input_ids": [6], "max_new_tokens": 2})
        assert err.value.code == 429
        assert float(err.value.headers["Retry-After"]) > 0
        body = json.loads(err.value.read())
        assert body["trace_id"] == err.value.headers["X-Trace-Id"]
    finally:
        server.shutdown()


# -- the tools -----------------------------------------------------------------


def _tokenizer(root):
    from tokenizers import SentencePieceUnigramTokenizer
    from transformers import PreTrainedTokenizerFast

    spm = SentencePieceUnigramTokenizer()
    spm.train_from_iterator(["the quick brown fox jumps over the lazy dog"] * 8, vocab_size=40,
                            unk_token="<unk>", special_tokens=["<unk>", "<s>", "</s>"])
    tok = PreTrainedTokenizerFast(tokenizer_object=spm._tokenizer, bos_token="<s>",
                                  eos_token="</s>", unk_token="<unk>")
    tok.save_pretrained(str(root))
    return tok


def test_generate_tool_decodes_reference_tokens(ref, tmp_path):
    """tools.generate on a port checkpoint and a tokenizer trained here:
    the text of the reference's greedy generate on the same weights and
    the same bucketed, left-padded prompts."""
    import argparse

    from llama_pipeline_parallel_tpu_torch.ckpt.checkpoint import CheckpointManager
    from llama_pipeline_parallel_tpu_torch.models.llama.manifest import StageManifest
    from llama_pipeline_parallel_tpu_torch.tools import generate as gen_tool

    ckpt = tmp_path / "ckpt"
    tok = _tokenizer(ckpt)
    jcfg = ref.LlamaConfig.tiny(vocab_size=tok.vocab_size, dtype=jnp.float32)
    tcfg = TConfig.tiny(vocab_size=tok.vocab_size)
    jp = ref.llama.init_params(jax.random.PRNGKey(1), jcfg)
    CheckpointManager(str(ckpt)).save(0, convert.params_from_jax(jp),
                                      StageManifest(num_layers=tcfg.num_hidden_layers,
                                                    num_stages=1), tcfg)
    prompts = ["the quick brown", "dog"]
    texts = gen_tool.run(argparse.Namespace(
        device="cpu", checkpoint_dir=str(ckpt), tokenizer_path=None, step=None, prompt=prompts,
        max_new_tokens=4, temperature=0.0, top_k=0, top_p=1.0, seed=0, bucket_sizes="32"))
    tok.padding_side = "left"
    tok.pad_token = tok.eos_token
    enc = tok(prompts, return_tensors="np", padding="max_length", max_length=32)
    want = np.asarray(ref.decode.generate(
        jp, jnp.asarray(enc["input_ids"], jnp.int32), jnp.asarray(enc["attention_mask"],
                                                                  jnp.int32), jcfg,
        ref.decode.GenerationConfig(max_new_tokens=4, eos_token_id=tok.eos_token_id,
                                    pad_token_id=tok.pad_token_id))["tokens"])
    expect = []
    for row in want.tolist():
        if tok.eos_token_id in row:
            row = row[:row.index(tok.eos_token_id)]
        expect.append(tok.decode(row, skip_special_tokens=True))
    assert texts == expect


def test_reports_equal_reference_tools(setup, tmp_path, capsys):
    """A traced serve run's directory (spans, metrics, request traces,
    exemplars) through the port's serving_report and request_report and
    through the reference's tools/: the same text."""
    import request_report as ref_request_report
    import serving_report as ref_serving_report

    from llama_pipeline_parallel_tpu_torch.tools import request_report, serving_report
    from llama_pipeline_parallel_tpu_torch.utils import trace as t_trace
    from llama_pipeline_parallel_tpu_torch.utils.metrics import MetricsWriter

    s = setup
    run = tmp_path / "run"
    t_trace.configure(str(run))
    writer = MetricsWriter(str(run))
    recorder = t_reqtrace.RequestTraceRecorder(str(run), exemplar_k=2)
    try:
        engine = ts.ServeEngine(s.tp, s.tcfg, config(ts, prefill_chunk_tokens=PAGE, **PAGED),
                                metrics_writer=writer, reqtrace=recorder, device="cpu")
        reqs = requests(s.tcfg.vocab_size, GREEDY)
        serve(ts, engine, [(p, g, sd) for p, g, sd in reqs])
        engine.shutdown()
    finally:
        writer.close()
        recorder.close()
        t_trace.configure(None)
    hint = "python -m llama_pipeline_parallel_tpu_torch.tools.request_report"
    for port_tool, ref_tool in ((serving_report, ref_serving_report),
                                (request_report, ref_request_report)):
        assert port_tool.main([str(run)]) == 0
        port_out = capsys.readouterr().out
        assert ref_tool.main([str(run)]) == 0
        ref_out = capsys.readouterr().out
        assert port_out.replace(hint, "tools/request_report.py") == ref_out
        assert len(port_out.splitlines()) > 5
