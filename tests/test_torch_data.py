"""The port's data path (data/collator.py, data/datasets.py, data/loader.py,
data/tokenization.py, data/text_utils.py) and its fault plan
(utils/faults.py) against the JAX package's, on the same inputs.

The tokenizer is a SentencePiece-Unigram model trained inside the test (the
algorithm family of LLaMA's tokenizer) and wrapped as a
`PreTrainedTokenizerFast`; nothing is downloaded. Each package gets its own
tokenizer object loaded from the same files, since expand_special_tokenizer
changes the object it is given. Collator arrays and loader batches are held
bit for bit, datasets item by item, and the fault plan by its verdicts,
counters and error messages.
"""

import importlib
import json
import re
import threading
import types

import numpy as np
import pytest

from llama_pipeline_parallel_tpu_torch.data import collator as t_collator
from llama_pipeline_parallel_tpu_torch.data import datasets as t_datasets
from llama_pipeline_parallel_tpu_torch.data import loader as t_loader
from llama_pipeline_parallel_tpu_torch.data import text_utils as t_text
from llama_pipeline_parallel_tpu_torch.data import tokenization as t_tok
from llama_pipeline_parallel_tpu_torch.utils import faults as t_faults


def _install_transfer_stand_in() -> None:
    """A stand-in for `jax._src.sharding_impls.TransferToMemoryKind` where this
    jax lacks it: the reference's host stash imports it, and on the CPU never
    constructs it."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind


# installed as the module is collected, so every worker has it before it
# imports the reference package
_install_transfer_stand_in()


@pytest.fixture(scope="session")
def ref():
    mods = {"collator": "data.collator", "datasets": "data.datasets",
            "loader": "data.loader", "tok": "data.tokenization",
            "text": "data.text_utils", "faults": "utils.faults"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


WORDS = ("the quick brown fox jumps over lazy dog pipeline parallelism cuts a model "
         "into stages what is capital of france paris summarize ring attention "
         "rotates key value slabs").split()


def flan_rows(n: int, seed: int, prompt_words=(2, 14), target_words=(1, 6)) -> list[dict]:
    """FLAN-style {"inputs", "targets"} rows of random words from a seed."""
    rng = np.random.RandomState(seed)
    return [{"inputs": " ".join(rng.choice(WORDS, rng.randint(*prompt_words))),
             "targets": " ".join(rng.choice(WORDS, rng.randint(*target_words)))}
            for _ in range(n)]


@pytest.fixture(scope="module")
def tokenizer_dir(tmp_path_factory):
    """A trained SentencePiece-Unigram tokenizer without a pad token, saved."""
    from tokenizers import SentencePieceUnigramTokenizer
    from transformers import PreTrainedTokenizerFast

    spm = SentencePieceUnigramTokenizer()
    spm.train_from_iterator([f"{r['inputs']} {r['targets']}" for r in flan_rows(64, 0)],
                            vocab_size=100, unk_token="<unk>",
                            special_tokens=["<unk>", "<s>", "</s>"])
    tok = PreTrainedTokenizerFast(tokenizer_object=spm._tokenizer, bos_token="<s>",
                                  eos_token="</s>", unk_token="<unk>")
    d = tmp_path_factory.mktemp("tok")
    tok.save_pretrained(str(d))
    return str(d)


def load_tokenizer(path: str, expand: bool = True):
    from transformers import AutoTokenizer

    tok = AutoTokenizer.from_pretrained(path)
    if expand:
        t_tok.expand_special_tokenizer(tok)
    return tok


def assert_batches_equal(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# ---------------------------------------------------------------------------
# collators and tokenization
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pack_factor,max_len", [(None, 40), (2, 48), (4, 40), (4, 24)],
                         ids=["causal", "packed-2", "packed-4", "packed-4-drops"])
def test_collators_match_reference(ref, tokenizer_dir, pack_factor, max_len):
    """CausalLMCollator and PackedCausalLMCollator give the reference's ids,
    segment ids, positions and labels bit for bit, and the packed one the
    same drop counters over two calls (a short row length makes it drop)."""
    got_tok, want_tok = load_tokenizer(tokenizer_dir), load_tokenizer(tokenizer_dir)
    if pack_factor is None:
        got_c = t_collator.CausalLMCollator(got_tok, max_len)
        want_c = ref.collator.CausalLMCollator(want_tok, max_len)
    else:
        got_c = t_collator.PackedCausalLMCollator(got_tok, max_len, pack_factor=pack_factor)
        want_c = ref.collator.PackedCausalLMCollator(want_tok, max_len, pack_factor=pack_factor)
    for seed in (1, 2):
        rows = flan_rows(16, seed)
        assert_batches_equal(got_c(rows), want_c(rows))
    if pack_factor is not None:
        assert (got_c.dropped_total, got_c.packed_total) == \
            (want_c.dropped_total, want_c.packed_total)
        assert got_c.drop_rate() == want_c.drop_rate()
        if max_len == 24:
            assert got_c.dropped_total > 0
    inputs, targets = [r["inputs"] for r in rows], [r["targets"] for r in rows]
    assert t_collator.causal_texts(inputs, targets, "</s>") == \
        ref.collator.causal_texts(inputs, targets, "</s>")
    np.testing.assert_array_equal(t_collator.prompt_lengths(got_tok, inputs, max_len),
                                  ref.collator.prompt_lengths(want_tok, inputs, max_len))


def test_packed_rows_keep_the_packing_contract(tokenizer_dir):
    """Each packed segment holds one example's tokens with positions from 0,
    its first label IGNORE, and rows hold N // pack_factor rows."""
    tok = load_tokenizer(tokenizer_dir)
    rows = flan_rows(12, 3, prompt_words=(2, 5), target_words=(1, 3))
    packer = t_collator.PackedCausalLMCollator(tok, 96, pack_factor=3)
    out = packer(rows)
    assert (packer.dropped_total, packer.packed_total) == (0, 12)
    assert out["input_ids"].shape == (4, 96)
    alone = t_collator.CausalLMCollator(tok, 96)(rows)
    lengths = sorted(alone["attention_mask"].sum(1).tolist())
    found = []
    for r in range(4):
        seg = out["attention_mask"][r]
        for s in range(1, seg.max() + 1):
            at = np.flatnonzero(seg == s)
            np.testing.assert_array_equal(out["position_ids"][r, at], np.arange(len(at)))
            assert out["labels"][r, at[0]] == t_collator.IGNORE_INDEX
            found.append(len(at))
    assert sorted(found) == lengths  # nothing dropped, each example once


@pytest.mark.parametrize("env", [{}, {"EOS_TOKEN": "<eos_x>"}, {"PAD_TOKEN": "<pad>"},
                                 {"BOS_TOKEN": "<s>", "UNK_TOKEN": "<unk_y>"}],
                         ids=["none", "eos", "pad", "bos-unk"])
def test_expand_special_tokenizer_matches_reference(ref, tokenizer_dir, monkeypatch, env):
    """The same tokens added, the same specials and the same vocabulary, with
    and without the environment overrides (no pad: pad falls back to eos)."""
    for key in ("BOS_TOKEN", "EOS_TOKEN", "UNK_TOKEN", "PAD_TOKEN"):
        monkeypatch.delenv(key, raising=False)
    for key, value in env.items():
        monkeypatch.setenv(key, value)
    got_tok = load_tokenizer(tokenizer_dir, expand=False)
    want_tok = load_tokenizer(tokenizer_dir, expand=False)
    assert t_tok.expand_special_tokenizer(got_tok) == ref.tok.expand_special_tokenizer(want_tok)
    for attr in ("bos_token", "eos_token", "unk_token", "pad_token"):
        assert getattr(got_tok, attr) == getattr(want_tok, attr), attr
    assert got_tok.get_vocab() == want_tok.get_vocab() and len(got_tok) == len(want_tok)
    if not env:
        assert got_tok.pad_token == got_tok.eos_token == "</s>"


def test_seq2seq_tokenizers_are_refused_as_the_reference_refuses(ref):
    T5TokenizerFast = type("T5TokenizerFast", (), {})
    for mod in (t_tok, ref.tok):
        assert mod.tokenizer_get_name(T5TokenizerFast()) == "t5tokenizerfast"
        assert mod.is_seq2seq_tokenizer(T5TokenizerFast())
        with pytest.raises(ValueError, match="encoder-decoder"):
            mod.expand_special_tokenizer(T5TokenizerFast())


TEXTS = [
    ("The quick brown fox jumps over the lazy dog.", ["quick brown", "dog", "the"]),
    ("Paris is the capital of France; France's capital is Paris.", ["Paris", "France", "capital of"]),
    ("a b a b a", ["a b", "b a", "a"]),
    ("nested spans: new york city", ["new york city", "york", "city hall"]),
    ("don't split it's contractions, or 3.14 numbers!", ["it's", "3.14"]),
    ("", ["x"]),
]


@pytest.mark.parametrize("text,spans", TEXTS, ids=[f"t{i}" for i in range(len(TEXTS))])
def test_text_utils_match_reference(ref, text, spans):
    assert t_text.word_tokenize(text) == ref.text.word_tokenize(text)
    for span in spans + ["", " "]:
        assert t_text.find_spans(text, span) == ref.text.find_spans(text, span)
    positions = [p for span in spans for p in ref.text.find_spans(text, span)]
    positions += [(0, 3), (2, 6), (1, 2)]
    assert t_text.resolve_spans(positions) == ref.text.resolve_spans(positions)
    for word_split in (False, True):
        assert t_text.chunk_by_spans(text, spans, word_split) == \
            ref.text.chunk_by_spans(text, spans, word_split)
    offsets = [(m.start(), m.end()) for m in re.finditer(r"\S+", text)] + [(0, 0)]
    char_spans = [(0, 4), (5, 9), (100, 120)]
    assert t_text.char_to_token_spans(offsets, char_spans) == \
        ref.text.char_to_token_spans(offsets, char_spans)
    vocab = types.SimpleNamespace(get_vocab=lambda: {"[unused0]": 0, "[unused2]": 1})
    assert t_text.get_unused_tokens(vocab, 3) == ref.text.get_unused_tokens(vocab, 3)


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------

@pytest.fixture()
def corpus(tmp_path):
    """A .jsonl and a .json of FLAN-style rows, some with empty targets, and
    blank lines in the .jsonl."""
    rows = flan_rows(40, 7)
    for i in (3, 11, 12):
        rows[i]["targets"] = "  " if i % 2 else ""
    jsonl = tmp_path / "train.jsonl"
    lines = [json.dumps(r) for r in rows]
    lines.insert(5, "")
    jsonl.write_text("\n".join(lines) + "\n")
    js = tmp_path / "train.json"
    js.write_text(json.dumps(flan_rows(25, 8)))
    return str(jsonl), str(js)


def _items(ds) -> list:
    return [ds[i] for i in range(len(ds))]


@pytest.mark.parametrize("kind", ["json", "jsonl", "lazy", "lazy-unfiltered", "concat",
                                  "mixture"])
def test_datasets_match_reference(ref, corpus, kind):
    """All five datasets yield the reference's items in the reference's
    order (a mixture with weights 2:1 of a lazy and an in-memory source)."""
    jsonl, js = corpus

    def build(mod):
        if kind == "json":
            return mod.JsonSeq2SeqDataset(js)
        if kind == "jsonl":
            return mod.JsonSeq2SeqDataset(jsonl)
        if kind == "lazy":
            return mod.LazyJsonlDataset(jsonl)
        if kind == "lazy-unfiltered":
            return mod.LazyJsonlDataset(jsonl, filter_empty=False)
        if kind == "concat":
            return mod.ConcatDataset([mod.LazyJsonlDataset(jsonl), mod.JsonSeq2SeqDataset(js)])
        return mod.MixtureDataset([mod.LazyJsonlDataset(jsonl), mod.JsonSeq2SeqDataset(js)],
                                  weights=[2.0, 1.0])

    got, want = build(t_datasets), build(ref.datasets)
    assert len(got) == len(want) > 0
    assert _items(got) == _items(want)
    if kind == "concat":
        assert got[-1] == want[-1]
    with pytest.raises(IndexError):
        got[len(got) + 100] if kind in ("concat", "mixture") else got[len(got)]
    assert t_datasets.load_seq2seq_records(jsonl, filter_fn=t_datasets.drop_empty_targets) == \
        ref.datasets.load_seq2seq_records(jsonl, filter_fn=ref.datasets.drop_empty_targets)


def test_lazy_dataset_reads_from_two_threads(ref, corpus):
    """Two threads read one LazyJsonlDataset in opposite orders, each through
    its own handle, and both see the reference's items."""
    jsonl, _ = corpus
    ds = t_datasets.LazyJsonlDataset(jsonl)
    want = _items(ref.datasets.LazyJsonlDataset(jsonl))
    seen: dict[str, list] = {}

    def read(name, order):
        seen[name] = [(i, ds[i]) for _ in range(5) for i in order]

    threads = [threading.Thread(target=read, args=("up", range(len(ds)))),
               threading.Thread(target=read, args=("down", range(len(ds) - 1, -1, -1)))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for pairs in seen.values():
        assert len(pairs) == 5 * len(want)
        assert all(item == want[i] for i, item in pairs)


def test_mixture_refusals_match_reference(ref, corpus):
    jsonl, _ = corpus
    for mod in (t_datasets, ref.datasets):
        src = mod.JsonSeq2SeqDataset(jsonl)
        with pytest.raises(ValueError, match="at least one"):
            mod.MixtureDataset([])
        with pytest.raises(ValueError, match="bad weights"):
            mod.MixtureDataset([src, src], weights=[1.0, 0.0])
        with pytest.raises(ValueError, match="too extreme"):
            mod.MixtureDataset([src, src], weights=[1.0, 1e6])


# ---------------------------------------------------------------------------
# the loader
# ---------------------------------------------------------------------------

@pytest.fixture()
def fast_retry(monkeypatch):
    """Two tries, no backoff: a persistently bad record costs no sleep."""
    monkeypatch.setenv("LPT_RETRY_MAX_ATTEMPTS", "2")
    monkeypatch.setenv("LPT_RETRY_BASE_DELAY_S", "0")
    monkeypatch.setenv("LPT_RETRY_SEED", "0")
    monkeypatch.delenv(t_faults.ENV_PLAN, raising=False)
    yield
    t_faults.configure(None)


def _loaders(ref, tokenizer_dir, jsonl, pack_factor=2, **kw):
    out = []
    for mod, ds_mod in ((t_loader, t_datasets), (ref.loader, ref.datasets)):
        tok = load_tokenizer(tokenizer_dir)
        coll = (t_collator if mod is t_loader else ref.collator).PackedCausalLMCollator(
            tok, 48, pack_factor=pack_factor)
        out.append(mod.DataLoader(ds_mod.LazyJsonlDataset(jsonl), coll,
                                  per_replica_batch=3 * pack_factor, seed=5, **kw))
    return out


@pytest.mark.parametrize("start_epoch,start_batch", [(0, 0), (0, 4), (2, 1)])
def test_loader_batches_match_reference(ref, tokenizer_dir, corpus, fast_retry, start_epoch,
                                        start_batch):
    """Packed batches from a JSONL, bit for bit, opened mid-run at (epoch,
    batch) without reading a skipped record, through the prefetch thread,
    with the reference's drop counters."""
    jsonl, _ = corpus
    got_l, want_l = _loaders(ref, tokenizer_dir, jsonl)
    assert len(got_l) == len(want_l) == 6 and got_l.global_batch_examples == 6
    got = t_loader.PrefetchIterator(iter(t_loader.RepeatingLoader(got_l, start_epoch,
                                                                  start_batch)), depth=2)
    want = iter(ref.loader.RepeatingLoader(want_l, start_epoch, start_batch))
    for _ in range(8):
        assert_batches_equal(next(got), next(want))
    assert got_l.records_read >= want_l.records_read == 8 * 6
    assert got_l.collate_fn.dropped_total >= want_l.collate_fn.dropped_total


def test_loader_quarantine_and_ledger_match_reference(ref, tokenizer_dir, corpus, fast_retry,
                                                      tmp_path):
    """Under a `data_read` corrupt rule on every index holding a 3, both
    loaders quarantine the same records, substitute the same ones, and write
    the same samples.jsonl lines; without the quarantine the read error ends
    the stream in both."""
    jsonl, _ = corpus
    plan = {"seed": 1, "faults": [{"site": "data_read", "op": "corrupt", "match": "3"}]}
    t_faults.configure(plan)
    ref.faults.configure(plan)
    try:
        got_l, want_l = _loaders(ref, tokenizer_dir, jsonl, quarantine_bad_records=True)
        got_l.sample_ledger, want_l.sample_ledger = None, None
        got_l._ledger_f = open(tmp_path / "got.jsonl", "a", buffering=1)
        want_l._ledger_f = open(tmp_path / "want.jsonl", "a", buffering=1)
        got_it = iter(t_loader.RepeatingLoader(got_l))
        want_it = iter(ref.loader.RepeatingLoader(want_l))
        for _ in range(8):
            assert_batches_equal(next(got_it), next(want_it))
        got_l.close_ledger()
        want_l.close_ledger()
        assert got_l.quarantine_count == want_l.quarantine_count > 0
        assert got_l._quarantined == want_l._quarantined
        assert got_l.records_read == want_l.records_read
        assert (tmp_path / "got.jsonl").read_text() == (tmp_path / "want.jsonl").read_text()
        assert len((tmp_path / "got.jsonl").read_text().splitlines()) == 8

        got_l, want_l = _loaders(ref, tokenizer_dir, jsonl)
        for loader, err in ((got_l, t_loader.CorruptRecordError),
                            (want_l, ref.loader.CorruptRecordError)):
            with pytest.raises(err, match="corrupt"):
                for _ in loader:
                    pass
    finally:
        ref.faults.configure(None)


def test_loader_writes_the_sample_ledger_it_is_given(tokenizer_dir, corpus, tmp_path):
    jsonl, _ = corpus
    tok = load_tokenizer(tokenizer_dir)
    path = tmp_path / "samples.jsonl"
    loader = t_loader.DataLoader(t_datasets.LazyJsonlDataset(jsonl),
                                 t_collator.CausalLMCollator(tok, 40), per_replica_batch=4,
                                 seed=2, sample_ledger=str(path))
    order = loader._samplers[0].indices()
    batches = list(loader.iter_batches(3))
    loader.close_ledger()
    loader.close_ledger()  # a second close is a no-op
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert len(lines) == len(batches) == len(loader) - 3
    assert lines[0] == {"epoch": 0, "batch": 3, "indices": order[12:16].tolist()}


def test_loader_dp_range_matches_reference(ref, corpus):
    """dp_size 2 read by one process (dp_range (1, 1)): the same rows."""
    jsonl, _ = corpus

    def ids(mod, ds_mod):
        loader = mod.DataLoader(ds_mod.LazyJsonlDataset(jsonl), lambda rows: rows,
                                per_replica_batch=3, dp_size=2, seed=4, dp_range=(1, 1))
        return [list(b) for b in loader]

    assert ids(t_loader, t_datasets) == ids(ref.loader, ref.datasets)
    with pytest.raises(ValueError, match="dp_range"):
        t_loader.DataLoader([], lambda r: r, per_replica_batch=1, dp_size=2, dp_range=(1, 2))


class _Boom(RuntimeError):
    pass


def _fails_after(n):
    yield from range(n)
    raise _Boom("producer failed")


@pytest.mark.parametrize("depth", [1, 3])
def test_prefetch_iterator_matches_reference(ref, depth):
    """The same order, the error raised on the consumer after the items
    before it, and a sticky end, in both packages."""
    for mod in (t_loader, ref.loader):
        assert list(mod.PrefetchIterator(iter(range(20)), depth=depth)) == list(range(20))
        it = mod.PrefetchIterator(_fails_after(4), depth=depth)
        assert [next(it) for _ in range(4)] == [0, 1, 2, 3]
        for _ in range(2):  # the failure is sticky
            with pytest.raises(_Boom, match="producer failed"):
                next(it)
        done = mod.PrefetchIterator(iter([]), depth=depth)
        for _ in range(2):
            with pytest.raises(StopIteration):
                next(done)
        with pytest.raises(ValueError, match="depth must be >= 1"):
            mod.PrefetchIterator(iter([]), depth=0)


# ---------------------------------------------------------------------------
# the fault plan
# ---------------------------------------------------------------------------

PLAN = {"seed": 3, "faults": [
    {"site": "storage_write", "op": "error", "match": "meta.json", "times": 2},
    {"site": "data_read", "op": "corrupt", "every": 3, "after": 1},
    {"site": "data_read", "op": "corrupt", "p": 0.5},
    {"site": "step", "op": "grad_nonfinite", "at_step": 4, "stage": 1},
    {"site": "device_probe", "op": "device_loss", "devices": 2},
    {"site": "step", "op": "oom", "at_step": 6},
    {"site": "barrier", "op": "stall", "seconds": 0.0},
]}
CALLS = ([("storage_write", "ckpt/meta.json", None)] * 3
         + [("storage_write", "ckpt/params", None)]
         + [("data_read", str(i), None) for i in range(12)]
         + [("step", "", s) for s in range(8)]
         + [("device_probe", "", None), ("barrier", "x", None)])


def _fire_all(injector, errors):
    out = []
    for site, tag, step in CALLS:
        try:
            out.append(injector.fire(site, tag, step=step))
        except errors as e:
            out.append(f"raised {type(e).__name__}: {e}")
    return out


def test_fault_plan_fires_as_the_reference(ref, monkeypatch, tmp_path):
    """A plan with every rule field parses and fires identically (verdicts,
    raised errors, counters), through configure, configure_from_env (inline
    JSON and @path) and the module-level fire / has_rule / rule_field_values."""
    got = _fire_all(t_faults.FaultInjector(PLAN), t_faults.InjectedFault)
    want = _fire_all(ref.faults.FaultInjector(PLAN), ref.faults.InjectedFault)
    assert got == want
    assert sum(v is not None and v.startswith("raised InjectedFault") for v in got) == 2
    assert issubclass(t_faults.InjectedFault, OSError)

    path = tmp_path / "plan.json"
    path.write_text(json.dumps(PLAN))
    for raw in (json.dumps(PLAN), f"@{path}", str(path)):
        monkeypatch.setenv(t_faults.ENV_PLAN, raw)
        t_faults.configure_from_env()
        ref.faults.configure_from_env()
        try:
            assert _fire_all(t_faults, t_faults.InjectedFault) == \
                _fire_all(ref.faults, ref.faults.InjectedFault)
            assert t_faults.active().stats() == ref.faults.active().stats()
            for site, op, field in (("step", "grad_nonfinite", "stage"),
                                    ("device_probe", "device_loss", "devices")):
                assert t_faults.has_rule(site, op) and ref.faults.has_rule(site, op)
                assert t_faults.rule_field_values(site, op, field) == \
                    ref.faults.rule_field_values(site, op, field)
        finally:
            t_faults.configure(None)
            ref.faults.configure(None)
    assert t_faults.fire("storage_write", "meta.json") is None
    assert not t_faults.has_rule("step", "oom")


@pytest.mark.parametrize("plan", [
    {"faults": [{"site": "disk", "op": "error"}]},
    {"faults": [{"site": "step", "op": "explode"}]},
    {"faults": [{"op": "error"}]},
    {"faults": [{"site": "step", "op": "die", "when": 3}]},
    {"faults": [{"site": "step", "op": "die", "signal": "SIGNOPE"}]},
    {"faults": [{"site": "device_probe", "op": "device_loss", "devices": -1}]},
    {"faults": {"site": "step"}},
    ["not", "a", "dict"],
], ids=["site", "op", "missing", "keys", "signal", "devices", "faults", "plan"])
def test_fault_plan_errors_match_reference(ref, plan):
    """A malformed plan is refused with the reference's message."""
    with pytest.raises(t_faults.FaultPlanError) as got:
        t_faults.FaultInjector(plan)
    with pytest.raises(ref.faults.FaultPlanError) as want:
        ref.faults.FaultInjector(plan)
    assert str(got.value) == str(want.value)


def test_fault_plan_env_errors_match_reference(ref, monkeypatch):
    monkeypatch.setenv(t_faults.ENV_PLAN, "{not json")
    with pytest.raises(t_faults.FaultPlanError) as got:
        t_faults.configure_from_env()
    with pytest.raises(ref.faults.FaultPlanError) as want:
        ref.faults.configure_from_env()
    assert str(got.value) == str(want.value)
    t_faults.configure(None)
    ref.faults.configure(None)
