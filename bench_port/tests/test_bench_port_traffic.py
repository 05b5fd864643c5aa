"""The traffic generator is a function of the seed, every step of every seed does
the same work in its own layout, and the reference rebuilds the port's packed
rows exactly."""

import numpy as np
import pytest

from bench_port import cells, generator
from bench_port.tokenizer import WordTokenizer

SEED = 2**31 + 77
TRAFFIC = sorted({w["traffic"] for w in cells.benchmark()["workloads"]})
PACKED = "mistral7b-stage.sft-packed-4k"


def _traffic(name):
    return cells.load(next(w["name"] for w in cells.benchmark()["workloads"]
                           if w["traffic"] == name)).traffic


def _packed():
    t = cells.load(PACKED).traffic
    return t, generator.kind(t)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_records_are_a_function_of_the_seed(traffic):
    t = _traffic(traffic)
    a, b = generator.make_dataset(t, SEED, 32000), generator.make_dataset(t, SEED, 32000)
    other = generator.make_dataset(t, SEED + 1, 32000)
    for i in (0, 5, len(a) - 1):
        ra, rb, ro = a.record(i, i), b.record(i, i), other.record(i, i)
        for k in ra:
            assert np.array_equal(np.asarray(ra[k]), np.asarray(rb[k]))
        assert any(not np.array_equal(np.asarray(ra[k]), np.asarray(ro[k])) for k in ra)


@pytest.mark.parametrize("traffic", TRAFFIC)
def test_each_kind_is_a_module_found_by_name(traffic):
    module = generator.kind(_traffic(traffic))
    for name in ("make_dataset", "port_data", "reference_rows", "SEGMENTED"):
        assert hasattr(module, name), name


def test_an_unknown_kind_is_refused():
    with pytest.raises(ValueError, match="unknown documents kind"):
        generator.kind({"documents": {"kind": "no_such_kind"}})


def test_apportion_keeps_the_total_and_the_bounds():
    kind = _packed()[1]
    w = np.random.default_rng(0).lognormal(0.0, 1.0, 80)
    for total, lo, hi in ((2496, 1, 4093), (28456, 1, 1000), (80, 1, 4093), (800, 1, 10)):
        got = kind.apportion(w, total, lo, hi)
        assert got.sum() == total and got.min() >= lo and got.max() <= hi
    assert kind.apportion(np.ones(4), 10, 1, 9).tolist() == [3, 3, 2, 2]
    with pytest.raises(ValueError):
        kind.apportion(w, 79, 1, 10)


def test_every_step_of_every_seed_holds_the_same_tokens_in_its_own_layout():
    t, kind = _packed()
    docs, per = t["documents"], generator.examples_per_step(t)
    a = generator.make_dataset(t, SEED, 32000)
    b = generator.make_dataset(t, SEED + 9, 32000)
    assert a.lengths.shape == (docs["plan_steps"], per, 2)
    for ds in (a, b):
        assert (ds.lengths[..., 0].sum(1) == round(per * docs["prompt_mean"])).all()
        assert (ds.lengths[..., 1].sum(1) == round(per * docs["response_mean"])).all()
        assert (ds.lengths.min() >= 1) and (ds.lengths.sum(2) + 2 <= docs["cap"]).all()
    assert not np.array_equal(np.sort(a.lengths[0], 0), np.sort(b.lengths[0], 0))
    assert not np.array_equal(np.sort(a.lengths[0], 0), np.sort(a.lengths[1], 0))
    # the text is the plan's: one word a token
    for j in (0, per - 1, per):
        r = a.record(99, j)
        assert [len(r["inputs"].split()), len(r["targets"].split())] == \
            a.lengths.reshape(-1, 2)[j].tolist()


def test_records_follow_the_loaders_reads_after_the_probe():
    t, _ = _packed()
    ds = generator.make_dataset(t, SEED, 32000)
    per = ds.per_step
    assert ds[0] is ds.plan[0]                          # build_run's probe
    got = [ds[i] for i in (999, 998, *range(per - 2), 7)]  # step 0, then step 1's first
    assert got[:per] == ds.plan[:per] and got[per] is ds.plan[per]
    assert ds.step_records(0) == ds.plan[:per]


def test_fetch_log_gives_each_steps_records():
    t = dict(_traffic("full-4k"), rows_per_microbatch=1, microbatches=2)
    ds = generator.make_dataset(t, SEED, 32000)
    for i in (0, 7, 3, 9, 1):
        ds[i]
    got = ds.step_records(1)
    assert [np.array_equal(g["input_ids"], ds.record(i, 0)["input_ids"]) for g, i in
            zip(got, (9, 1))] == [True, True]
    with pytest.raises(RuntimeError, match="read 0 of 2"):
        ds.step_records(2)
    ds[4], ds[4]
    with pytest.raises(RuntimeError, match="twice"):
        ds.step_records(2)


def test_tokenizer_splits_the_glued_eos():
    tok = WordTokenizer(32000)
    assert tok.encode("w0 w7</s>") == [1, 4, 11, 2]
    assert tok(["w1 w2", "w3"], max_length=2, truncation=True,
               return_length=True) == {"input_ids": [[1, 5], [1, 7]], "length": [2, 2]}


def test_packed_rows_match_the_port_collator():
    from llama_pipeline_parallel_tpu_torch.data.collator import PackedCausalLMCollator

    t, kind = _packed()
    ds = generator.make_dataset(t, SEED, 32000)
    tok = WordTokenizer(32000)
    collate = PackedCausalLMCollator(tok, t["seq_length"], pack_factor=t["packing_factor"])
    assert kind.port_data(t) == {"packing_factor": t["packing_factor"]}
    per = ds.per_step
    for step in range(3):
        records = ds.plan[per * step:per * (step + 1)]
        port = collate(records)
        ref = kind.reference_rows(records, t, tok)
        assert np.array_equal(port["input_ids"], ref["input_ids"])
        assert np.array_equal(port["attention_mask"], ref["segments"])
        assert np.array_equal(port["position_ids"], ref["positions"])
        assert np.array_equal(port["labels"], ref["labels"])
        assert (port["attention_mask"] == 0).sum() == port["input_ids"].size - (
            ds.lengths[step].sum() + 2 * per)
    assert collate.dropped_total == 0


def test_packing_factor_is_the_least_pad_under_two_percent_drops():
    """Each step's pairs, first-fit-decreasing into the step's rows over 20
    seeds: the recorded factor drops under 2 %; one more pair a row would
    need more tokens than the rows hold."""
    t, kind = _packed()
    rows, seq, docs = t["rows_per_microbatch"] * t["microbatches"], t["seq_length"], t["documents"]
    pf = t["packing_factor"]
    per = rows * pf
    dropped = 0
    for seed in range(20):
        for s in range(docs["plan_steps"]):
            used = [0] * rows
            for x in sorted(kind.step_lengths(docs, seed, s, per).sum(1) + 2, reverse=True):
                r = next((r for r in range(rows) if used[r] + x <= seq), None)
                if r is None:
                    dropped += 1
                else:
                    used[r] += x
    assert dropped < 0.02 * 20 * docs["plan_steps"] * per
    mean_pair = docs["prompt_mean"] + docs["response_mean"] + 2
    assert rows * (pf + 1) * mean_pair > rows * seq
