"""The port's KV-cache decoding (models/llama/decode.py) against the JAX
package's, on the CPU at the `tiny` preset in fp32, inputs from a numpy
seed and parameters carried across with `convert.params_from_jax`.

Limits:
- `forward_with_cache`, `prefill_prompt`, `paged_prefill_chunk` and
  `paged_prefill_span` logits within 1e-5, fp and int8 pages; caches and
  fp pools within 1e-6 (a left pad's k/v is the mean of v over the row,
  as in the reference, since an int8 page's scale reads it);
- greedy tokens of `generate`, `decode_step` and `paged_decode_step` equal;
- int8 pages: scales within 1e-6 relative, codes equal except <= 1 % one
  code apart where the inputs differ by rounding;
- the top-k and top-p filters give the same -inf pattern on the same
  logits; greedy rows of `sample_rowwise` equal; sampled rows (whose
  generators differ across frameworks) are held to the filtered support and
  to their own seed;
- an id the reference would clamp raises in the port.
The port's own contracts (a row's tokens never depend on its batch) hold
exactly.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch import convert
from llama_pipeline_parallel_tpu_torch.models.llama import decode as td
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig as TConfig

LOGIT_TOL = 1e-5
POOL_TOL = 1e-6
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
    from llama_pipeline_parallel_tpu.models.llama import decode, model
    from llama_pipeline_parallel_tpu.models.llama.config import LlamaConfig

    return types.SimpleNamespace(decode=decode, llama=model, LlamaConfig=LlamaConfig)


@pytest.fixture(scope="module")
def setup(ref):
    jcfg = ref.LlamaConfig.tiny(dtype=jnp.float32)
    tcfg = TConfig.tiny(dtype=torch.float32)
    jp = ref.llama.init_params(jax.random.PRNGKey(0), jcfg)
    return types.SimpleNamespace(jcfg=jcfg, tcfg=tcfg, jp=jp, tp=convert.params_from_jax(jp))


def left_padded(rs, vocab, lengths, width):
    ids = np.zeros((len(lengths), width), np.int32)
    mask = np.zeros((len(lengths), width), np.int32)
    for r, n in enumerate(lengths):
        ids[r, width - n:] = rs.randint(3, vocab, n)
        mask[r, width - n:] = 1
    return ids, mask


def close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def ref_layout(cache):
    """The port's dense cache [L, kv_h, b, len, hd] in the reference's
    layout [L, b, len, kv_h, hd]."""
    return cache.permute(0, 2, 3, 1, 4)


def real_kv(cache, mask):
    """[L, b, len, ...] cache values (the reference's layout) at the rows'
    real positions."""
    c = cache.detach().numpy() if isinstance(cache, torch.Tensor) else np.asarray(cache)
    return c[:, mask.astype(bool)]


# -- the dense cache ---------------------------------------------------------


def test_forward_with_cache_prefill_and_decode(ref, setup):
    """A left-padded prefill then one decode step: logits and the cache's
    real positions match."""
    s = setup
    rs = np.random.RandomState(0)
    ids, mask = left_padded(rs, s.tcfg.vocab_size, (7, 4), 7)
    max_len = 10
    pos = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
    kv_mask = np.pad(mask, ((0, 0), (0, max_len - 7)))
    jl, jc = ref.decode.forward_with_cache(
        s.jp, jnp.asarray(ids), ref.decode.init_kv_cache(s.jcfg, 2, max_len), jnp.asarray(pos),
        0, jnp.asarray(kv_mask), s.jcfg, causal=True)
    tc = td.init_kv_cache(s.tcfg, 2, max_len, device="cpu")
    tl, tc = td.forward_with_cache(s.tp, ids, tc, pos, 0, torch.as_tensor(kv_mask), s.tcfg,
                                   causal=True)
    real = mask.astype(bool)
    close(tl.numpy()[real], np.asarray(jl)[real], LOGIT_TOL)
    for k in ("k", "v"):   # pads included: a pad's k/v is the reference's
        close(ref_layout(tc[k])[:, :, :7], jc[k][:, :, :7], POOL_TOL)

    tok = np.asarray(jl)[:, -1].argmax(-1).astype(np.int32)
    kv_mask[:, 7] = 1
    nxt = (pos[:, -1] + 1)[:, None]
    jl2, jc = ref.decode.forward_with_cache(s.jp, jnp.asarray(tok[:, None]), jc,
                                            jnp.asarray(nxt), 7, jnp.asarray(kv_mask), s.jcfg,
                                            causal=False)
    tl2, tc = td.forward_with_cache(s.tp, tok[:, None], tc, nxt, 7, torch.as_tensor(kv_mask),
                                    s.tcfg, causal=False)
    close(tl2, jl2, LOGIT_TOL)
    close(ref_layout(tc["k"])[:, :, 7], jc["k"][:, :, 7], POOL_TOL)


@pytest.mark.parametrize("eos", [False, True])
def test_generate_greedy_left_padded_batch(ref, setup, eos):
    """Greedy generate on a left-padded batch: the reference's tokens and
    done flags; with eos set to a token the batch emits, the rows stop and
    pad as the reference's do."""
    s = setup
    rs = np.random.RandomState(1)
    ids, mask = left_padded(rs, s.tcfg.vocab_size, (5, 8, 3), 8)
    base = np.asarray(ref.decode.generate(s.jp, jnp.asarray(ids), jnp.asarray(mask), s.jcfg,
                                          ref.decode.GenerationConfig(max_new_tokens=6))["tokens"])
    kw = dict(max_new_tokens=6)
    if eos:
        kw.update(eos_token_id=int(base[1, 2]), pad_token_id=17)
    want = ref.decode.generate(s.jp, jnp.asarray(ids), jnp.asarray(mask), s.jcfg,
                               ref.decode.GenerationConfig(**kw))
    got = td.generate(s.tp, ids, mask, s.tcfg, td.GenerationConfig(**kw))
    np.testing.assert_array_equal(got["tokens"].numpy(), np.asarray(want["tokens"]))
    np.testing.assert_array_equal(got["done"].numpy(), np.asarray(want["done"]))
    if eos:
        assert got["done"][1] and (got["tokens"][1, 3:] == 17).all()


def test_generate_row_invariance(setup):
    """A row's tokens do not depend on its batch: each row alone, at its own
    bucket-width padding, gives the batch's tokens, greedy and sampled
    (one generator a row)."""
    s = setup
    rs = np.random.RandomState(2)
    ids, mask = left_padded(rs, s.tcfg.vocab_size, (6, 2, 8), 8)
    for gen in (td.GenerationConfig(max_new_tokens=5),
                td.GenerationConfig(max_new_tokens=5, temperature=0.9, top_k=20, top_p=0.9)):
        gens = [torch.Generator().manual_seed(10 + r) for r in range(3)]
        batch = td.generate(s.tp, ids, mask, s.tcfg, gen, generator=gens)["tokens"]
        for r in range(3):
            alone = td.generate(s.tp, ids[r:r + 1], mask[r:r + 1], s.tcfg, gen,
                                generator=torch.Generator().manual_seed(10 + r))["tokens"]
            assert alone[0].tolist() == batch[r].tolist()


def test_prefill_prompt_decode_step_write_slot(ref, setup):
    """Two requests prefilled alone, spliced into a 3-slot cache at slots 2
    and 0, then greedy decode ticks with per-row positions: prefill logits,
    next positions, the spliced rows and every tick's tokens match."""
    s = setup
    rs = np.random.RandomState(3)
    slots, max_len, bucket = 3, 12, 6
    jcache = ref.decode.init_kv_cache(s.jcfg, slots, max_len)
    jmask = jnp.zeros((slots, max_len), jnp.int32)
    tcache = td.init_kv_cache(s.tcfg, slots, max_len, device="cpu")
    tmask = torch.zeros((slots, max_len), dtype=torch.int32)
    state = {}
    for slot, n in ((2, 4), (0, 6)):
        ids, mask = left_padded(rs, s.tcfg.vocab_size, (n,), bucket)
        jo = ref.decode.prefill_prompt(s.jp, jnp.asarray(ids), jnp.asarray(mask), s.jcfg, max_len)
        to = td.prefill_prompt(s.tp, ids, mask, s.tcfg, max_len)
        close(to["logits"], jo["logits"], LOGIT_TOL)
        assert to["next_pos"].tolist() == np.asarray(jo["next_pos"]).tolist()
        jcache, jmask = ref.decode.write_slot(jcache, jmask, jnp.int32(slot), jo["cache"],
                                              jo["kv_mask"])
        tcache, tmask = td.write_slot(tcache, tmask, slot, to["cache"], to["kv_mask"])
        state[slot] = (int(np.asarray(jo["logits"]).argmax()), int(to["next_pos"][0]))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for k in ("k", "v"):
        m = np.asarray(jmask)
        close(real_kv(ref_layout(tcache[k]), m), real_kv(jcache[k], m), POOL_TOL)

    token = np.zeros(slots, np.int32)
    pos = np.zeros(slots, np.int32)
    wp = np.zeros(slots, np.int32)
    for slot, (tok, p) in state.items():
        token[slot], pos[slot], wp[slot] = tok, p, bucket
    for _ in range(4):
        jo = ref.decode.decode_step(s.jp, jnp.asarray(token), jcache, jnp.asarray(pos),
                                    jnp.asarray(wp), jmask, jnp.zeros((slots, 2), jnp.uint32),
                                    jnp.zeros(slots), jnp.zeros(slots, jnp.int32),
                                    jnp.ones(slots), s.jcfg)
        to = td.decode_step(s.tp, token, tcache, pos, wp, tmask, [None] * slots,
                            np.zeros(slots), np.zeros(slots, np.int64), np.ones(slots), s.tcfg)
        jt = np.asarray(jo["token"])
        assert to["token"][[0, 2]].tolist() == jt[[0, 2]].tolist()
        jcache, jmask = jo["cache"], jo["kv_mask"]
        token, pos, wp = jt.astype(np.int32), pos + 1, wp + 1
    np.testing.assert_array_equal(tmask.numpy()[[0, 2]], np.asarray(jmask)[[0, 2]])


# -- int8 pages --------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quant_dequant_page_block(ref, seed):
    """Block absmax scales within 1e-6 relative; codes equal except <= 1 %
    one code apart (where x * (127 / scale) lands on a rounding boundary
    the two frameworks reach by different fp32 roundings); the dequantized
    blocks within the reference's per-page bound of the inputs."""
    x = np.random.RandomState(seed).randn(4, 8, 2, 16).astype(np.float32)
    js = ref.decode._block_amax(jnp.asarray(x), axes=(1, 3))
    ts = td._block_amax(torch.as_tensor(x), (1, 3))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=1e-6, atol=0)
    jq = np.asarray(ref.decode.quant_page_block(jnp.asarray(x), js[:, None, :, None]))
    tq = td.quant_page_block(torch.as_tensor(x), ts[:, None, :, None]).numpy()
    diff = np.abs(jq.astype(np.int32) - tq.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
    deq = td.dequant_page_block(torch.as_tensor(tq), ts[:, None, :, None], torch.float32)
    bound = ts.numpy()[:, None, :, None] / 127.0 * 0.5000001
    assert (np.abs(deq.numpy() - x) <= bound).all()
    # round half to even, as jnp.round
    half = torch.tensor([0.5, 1.5, 2.5, -0.5, -1.5])
    assert td.quant_page_block(half, torch.tensor(127.0)).tolist() == [0, 2, 2, 0, -2]


# -- the page pool -----------------------------------------------------------


def _pools(ref, s, quant, num_pages):
    jpool = ref.decode.init_page_pool(s.jcfg, num_pages, PAGE, quant)
    tpool = td.init_page_pool(s.tcfg, num_pages, PAGE, quant, device="cpu")
    return jpool, tpool


def _compare_pools(jpool, tpool, pages, offsets):
    """Pools at (page, offset) pairs: fp values 1e-6; int8 scales 1e-6
    relative, codes one apart at most on <= 1 % of them."""
    pages, offsets = np.asarray(pages), np.asarray(offsets)
    for k in ("k", "v"):   # the port's pool is heads first: [L, kv_h, pages, page, hd]
        jv = np.asarray(jpool[k])[:, pages, offsets]
        tv = tpool[k].numpy()[:, :, pages, offsets].transpose(0, 2, 1, 3)
        if tv.dtype == np.int8:
            diff = np.abs(jv.astype(np.int32) - tv.astype(np.int32))
            assert diff.max() <= 1 and (diff > 0).mean() <= 0.01
            sc = (slice(None), np.unique(pages))
            np.testing.assert_allclose(tpool[f"{k}_scale"].numpy()[sc],
                                       np.asarray(jpool[f"{k}_scale"])[sc], rtol=1e-6, atol=0)
        else:
            close(tv, jv, POOL_TOL)


@pytest.mark.parametrize("quant", ["fp", "int8"])
def test_paged_prefill_chunk_span_and_decode(ref, setup, quant):
    """Slot 0 prefills a left-padded 8-token row in two page-aligned chunks;
    slot 1 prefills a 7-token row as two unaligned spans (the second starts
    mid-page); then greedy paged decode ticks with both rows active and a
    third, inactive row riding along (its writes go to the garbage page).
    Logits of every chunk and span, the pools at every written position and
    the decode tokens match."""
    s = setup
    rs = np.random.RandomState(4)
    slots, max_len, num_pages = 3, 16, 12
    per = max_len // PAGE
    table = np.full((slots, per), num_pages, np.int32)
    table[0] = [0, 1, 2, 3]
    table[1] = [5, 4, 7, 6]
    jpool, tpool = _pools(ref, s, quant, num_pages)
    jmask = jnp.zeros((slots, max_len), jnp.int32)
    tmask = torch.zeros((slots, max_len), dtype=torch.int32)
    written = []
    state = {}
    rows = {0: left_padded(rs, s.tcfg.vocab_size, (5,), 8),
            1: left_padded(rs, s.tcfg.vocab_size, (7,), 7)}
    plans = {0: (("chunk", 0, 4), ("chunk", 4, 8)), 1: (("span", 0, 5), ("span", 5, 7))}
    for slot, (ids, mask) in rows.items():
        pos = np.clip(np.cumsum(mask, 1) - 1, 0, None).astype(np.int32)
        for kind, a, b in plans[slot]:
            jf = getattr(ref.decode, f"paged_prefill_{kind}")
            tf = getattr(td, f"paged_prefill_{kind}")
            jo = jf(s.jp, jnp.asarray(ids[:, a:b]), jnp.asarray(mask[:, a:b]),
                    jnp.asarray(pos[:, a:b]), jpool, jnp.asarray(table[slot]), jnp.int32(slot),
                    jmask, jnp.int32(a), s.jcfg)
            to = tf(s.tp, ids[:, a:b], mask[:, a:b], pos[:, a:b], tpool, table[slot], slot,
                    tmask, a, s.tcfg)
            close(to["logits"], jo["logits"], LOGIT_TOL)
            jpool, jmask = jo["pool"], jo["kv_mask"]
        written += [(table[slot][p // PAGE], p % PAGE) for p in range(ids.shape[1])
                    if mask[0, p]]
        state[slot] = (int(np.asarray(jo["logits"]).argmax()), int(pos[0, -1]) + 1,
                       ids.shape[1])
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _compare_pools(jpool, tpool, *zip(*written))

    token = np.zeros(slots, np.int32)
    pos = np.zeros(slots, np.int32)
    wp = np.zeros(slots, np.int32)
    active = np.asarray([1, 1, 0], np.int32)
    for slot, (tok, p, w) in state.items():
        token[slot], pos[slot], wp[slot] = tok, p, w
    for _ in range(3):
        jo = ref.decode.paged_decode_step(
            s.jp, jnp.asarray(token), jpool, jnp.asarray(table), jnp.asarray(pos),
            jnp.asarray(wp), jmask, jnp.asarray(active), jnp.zeros((slots, 2), jnp.uint32),
            jnp.zeros(slots), jnp.zeros(slots, jnp.int32), jnp.ones(slots), s.jcfg)
        to = td.paged_decode_step(s.tp, token, tpool, table, pos, wp, tmask, active,
                                  [None] * slots, np.zeros(slots), np.zeros(slots, np.int64),
                                  np.ones(slots), s.tcfg)
        jt = np.asarray(jo["token"])
        assert to["token"][:2].tolist() == jt[:2].tolist()
        written += [(table[r][wp[r] // PAGE], wp[r] % PAGE) for r in (0, 1)]
        jpool, jmask = jo["pool"], jo["kv_mask"]
        token, pos, wp = jt.astype(np.int32), pos + 1, wp + np.asarray([1, 1, 0], np.int32)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    _compare_pools(jpool, tpool, *zip(*written))


def test_write_pages_copy_page_and_mask_rows(ref, setup):
    """write_pages of a bucket-sized prefill (int8), copy_page (scales
    included), set_kv_mask_row and reset_kv_mask_row against the
    reference's."""
    s = setup
    rs = np.random.RandomState(5)
    ids, mask = left_padded(rs, s.tcfg.vocab_size, (6,), 8)
    jpool, tpool = _pools(ref, s, "int8", 8)
    jmask = jnp.zeros((2, 16), jnp.int32)
    tmask = torch.zeros((2, 16), dtype=torch.int32)
    jo = ref.decode.prefill_prompt(s.jp, jnp.asarray(ids), jnp.asarray(mask), s.jcfg, 8)
    to = td.prefill_prompt(s.tp, ids, mask, s.tcfg, 8)
    jpool, jmask = ref.decode.write_pages(jpool, jmask, jnp.int32(1), jnp.asarray([3, 1]),
                                          jo["cache"], jo["kv_mask"])
    td.write_pages(tpool, tmask, 1, [3, 1], to["cache"], to["kv_mask"])
    real = [(p, o) for i, (p, o) in enumerate((3, o) if i < 4 else (1, o - 4)
                                               for i, o in enumerate(range(8))) if mask[0, i]]
    _compare_pools(jpool, tpool, *zip(*real))
    jpool = ref.decode.copy_page(jpool, jnp.int32(3), jnp.int32(6))
    td.copy_page(tpool, 3, 6)
    for k in tpool:
        page_dim = 1 if k.endswith("scale") else 2
        np.testing.assert_array_equal(tpool[k].numpy().take(6, page_dim),
                                      tpool[k].numpy().take(3, page_dim))
    _compare_pools(jpool, tpool, [6] * 4, range(4))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    row = np.zeros((1, 16), np.int32)
    row[0, 2:7] = 1
    jmask = ref.decode.set_kv_mask_row(jmask, jnp.int32(0), jnp.asarray(row))
    td.set_kv_mask_row(tmask, 0, row)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    jmask = ref.decode.reset_kv_mask_row(jmask, jnp.int32(1))
    td.reset_kv_mask_row(tmask, 1)
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))


# -- sampling ----------------------------------------------------------------


@pytest.mark.parametrize("top_k,top_p", [(5, 1.0), (0, 0.9), (20, 0.7), (1, 0.5)])
def test_filters_same_support(ref, top_k, top_p):
    """Top-k and top-p give the reference's -inf pattern on the same
    logits (the reference's `_sample_row` filter, row by row)."""
    logits = np.random.RandomState(top_k).randn(6, 64).astype(np.float32) * 3
    temps = np.full(6, 0.8, np.float32)
    got = td.filter_logits(torch.as_tensor(logits), torch.as_tensor(temps),
                           torch.full((6,), top_k), torch.full((6,), top_p))
    l = jnp.asarray(logits) / 0.8
    want = []
    for r in range(6):
        row = l[r]
        kth = jnp.sort(row)[::-1][max(top_k, 1) - 1]
        row = jnp.where((top_k > 0) & (row < kth), -jnp.inf, row)
        row = jnp.where(top_p < 1.0, ref.decode._top_p_mask(row, top_p), row)
        want.append(np.asarray(row))
    np.testing.assert_array_equal(np.isinf(got.numpy()), np.isinf(np.stack(want)))
    if top_p < 1.0:   # (at 1.0 the filter is off; its cumsum may round past 1)
        tp_only = td._top_p_mask(torch.as_tensor(logits), top_p)
        np.testing.assert_array_equal(np.isinf(tp_only.numpy()),
                                      np.isinf(np.asarray(ref.decode._top_p_mask(
                                          jnp.asarray(logits), top_p))))


def test_sample_rowwise_greedy_and_sampled_rows(ref):
    """Greedy rows take the reference's argmax; sampled rows are repeatable
    under their seeds, independent of their co-tenants, and inside their
    filtered support; a sampled row without a generator is refused."""
    rs = np.random.RandomState(7)
    logits = torch.as_tensor(rs.randn(10, 50).astype(np.float32) * 2)
    temps = torch.tensor([0.0, 0.7, 0.0, 1.2, 0.9, 0.0, 0.5, 0.8, 0.0, 1.0])
    top_k = torch.tensor([0, 5, 0, 0, 10, 3, 0, 2, 0, 1])
    top_p = torch.tensor([1.0, 1.0, 0.5, 0.8, 0.9, 1.0, 0.3, 1.0, 1.0, 1.0])

    def gens(seed):
        return [torch.Generator().manual_seed(seed + r) if temps[r] > 0 else None
                for r in range(10)]

    a = td.sample_rowwise(logits, temps, top_k, top_p, gens(0))
    b = td.sample_rowwise(logits, temps, top_k, top_p, gens(0))
    assert a.tolist() == b.tolist()
    greedy = temps == 0
    jgreedy = np.asarray(ref.decode.sample_rowwise(
        jnp.asarray(logits.numpy()), jnp.zeros(10), jnp.zeros(10, jnp.int32), jnp.ones(10),
        jnp.zeros((10, 2), jnp.uint32)))
    assert a[greedy].tolist() == jgreedy[greedy.numpy()].tolist()
    support = td.filter_logits(logits, temps, top_k, top_p)
    assert torch.isfinite(support[torch.arange(10), a]).all()
    # a row's draw depends on its own generator only: alone, it is the same
    for r in (1, 3, 4):
        alone = td.sample_rowwise(logits[r:r + 1], temps[r:r + 1], top_k[r:r + 1],
                                  top_p[r:r + 1], [torch.Generator().manual_seed(r)])
        assert alone.item() == a[r].item()
    with pytest.raises(ValueError, match="no generator"):
        td.sample_rowwise(logits, temps, top_k, top_p, [None] * 10)


def test_out_of_range_inputs_raise(setup):
    """Where the reference clamps (a gather past the vocab, a write past the
    cache), the port raises."""
    s = setup
    ids = np.asarray([[3, 4, s.tcfg.vocab_size]], np.int32)
    with pytest.raises(ValueError, match="token ids"):
        td.generate(s.tp, ids, np.ones_like(ids), s.tcfg, td.GenerationConfig(max_new_tokens=2))
    cache = td.init_kv_cache(s.tcfg, 1, 4, device="cpu")
    mask = torch.ones((1, 4), dtype=torch.int32)
    with pytest.raises(ValueError, match="write_pos"):
        td.decode_step(s.tp, [3], cache, [4], [4], mask, [None], [0.0], [0], [1.0], s.tcfg)
    with pytest.raises(ValueError, match="page"):
        td.copy_page(td.init_page_pool(s.tcfg, 2, PAGE, device="cpu"), 0, 3)
