"""Autoregressive KV-cache decoding and the serving entry points.

The counterpart of llama_pipeline_parallel_tpu/models/llama/decode.py, as
plain functions on the flat parameter dict (models/llama/model.py):

- `generate`: batched generation from left-padded prompts (prefill, then one
  decode step a token over a `[n_layers, b, max_len, kv_heads, hd]` cache).
- the continuous-batching entry points of serve/: `prefill_prompt`,
  `decode_step` (per-row write positions, rope positions, generators and
  sampling knobs) and `write_slot` over the dense slot cache; the page pool
  (`init_page_pool`, int8 pages with one fp32 scale per (layer, page,
  kv head)), `paged_decode_step`, `paged_prefill_chunk` and
  `paged_prefill_span` over it.

JAX's buffer donation becomes in-place writes: the cache, the pool and the
kv mask handed to an entry point are updated where they lie and returned.
Out-of-range ids and positions, which JAX would clamp, raise.

**Row invariance.** The serving contracts ask for equal tokens from calls of
different shapes: a request served among 8 slots and `generate` on its
prompt alone, a prompt prefilled whole and in chunks, a prefix-cache hit
that recomputes only its tail. A library kernel is chosen by shape (cuBLAS
takes split-K for a small M, a softmax or a reduction its block size by
length), so a row's bits would depend on its co-tenants. Every op here
therefore runs at a fixed shape:
- the row-wise parts of a layer (norms, projections, RoPE, the MLP, the
  head) run on tiles of `ROW_TILE` rows (a decode tick, the head) or
  `PREFILL_TILE` tokens (a prefill), the last tile padded;
- attention runs one query tile at a time over kv blocks of `KV_BLOCK`
  positions, combined in order in fp32 (the max and the softmax denominator
  online, then the weighted values); a block that is masked for every
  query of the tile is an exact no-op (its weights are exactly 0 and its
  rescale factor exactly 1), so how many trailing or leading masked blocks
  a call visits, or how long its cache is, does not change a bit;
- sampling runs on tiles of `ROW_TILE` rows, one generator a request.
A row's result then depends only on its own inputs, never on which tile or
row it occupies. The arithmetic is the exact attention's (ops/attention.py)
with the same rounding points, its sums reassociated.

No op here is a kernel of the nine: decode and serving reach none of the
JAX package's Pallas kernels either (its prefill and decode attend through
the exact `ops.attention.attention`, its paged reads are a gather).
"""

from __future__ import annotations

import dataclasses
import weakref
from typing import Callable, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from llama_pipeline_parallel_tpu_torch.models.llama import model as llama
from llama_pipeline_parallel_tpu_torch.models.llama.config import LlamaConfig
from llama_pipeline_parallel_tpu_torch.ops.attention import NEG_INF
from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm
from llama_pipeline_parallel_tpu_torch.ops.rope import apply_rope, rope_cos_sin

Params = dict[str, torch.Tensor]
Generators = Sequence[torch.Generator | None]

ROW_TILE = 8          # rows of a decode tick's (and the head's) row-wise tiles
PREFILL_TILE = 256    # tokens of a prefill's row-wise and query tiles
KV_BLOCK = 1024       # kv positions of one attention block
# replay a decode step's forward as a CUDA graph on a card (one graph per
# cache or pool and per count of kv blocks): a tick is ~2,000 small launches,
# which eager dispatch makes host-bound
CUDA_GRAPHS = True

# absmax floor: an all-zero block quantizes against this instead of 0/0
_SCALE_FLOOR = 1e-8


@dataclasses.dataclass(frozen=True)
class GenerationConfig:
    max_new_tokens: int = 64
    temperature: float = 0.0     # 0 -> greedy
    top_k: int = 0               # 0 -> full distribution
    top_p: float = 1.0           # nucleus mass; 1.0 -> no nucleus filter
    eos_token_id: int | None = None
    pad_token_id: int = 0        # emitted after a row hits eos

    def __post_init__(self) -> None:
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1 (the decode loop "
                             "always emits the prefill-sampled token)")
        if not 0.0 < self.top_p <= 1.0:
            raise ValueError(f"top_p must be in (0, 1], got {self.top_p}")


# ---------------------------------------------------------------------------
# Parameters, caches, checks
# ---------------------------------------------------------------------------

def compute_params(params: Params, cfg: LlamaConfig,
                   device: str | torch.device | None = None) -> Params:
    """The one compute-dtype copy a decoder holds, on `device` (default: where
    each leaf lies): matmul weights, the embedding and the head cast to
    `cfg.dtype` once (the reference casts each at use, `w.astype(dt)`: the
    same values); the norms keep their dtype (rms_norm reads them in fp32).
    Leaf by leaf, so fp32 masters elsewhere never sit on `device` whole."""
    out = {}
    for n, t in params.items():
        dev = t.device if device is None else device
        out[n] = t.to(device=dev) if n.endswith("norm") else t.to(device=dev, dtype=cfg.dtype)
    return out


def _device(params: Params) -> torch.device:
    return params["embed.embedding"].device


def _layers(params: Params, cfg: LlamaConfig) -> list[Params]:
    """One dict a layer (names without `layers.`), leaves as views."""
    stacked = {n[len("layers."):]: t for n, t in params.items() if n.startswith("layers.")}
    return [{n: t[i] for n, t in stacked.items()} for i in range(cfg.num_hidden_layers)]


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def check_ids(ids, vocab: int, what: str = "token ids") -> None:
    """Raise where JAX's gather would clamp: an id outside [0, vocab)."""
    a = _host(ids)
    if a.size and (a.min() < 0 or a.max() >= vocab):
        raise ValueError(f"{what} must lie in [0, {vocab}); got values in "
                         f"[{a.min()}, {a.max()}]")


def _check_range(x, hi: int, what: str) -> np.ndarray:
    """Raise where JAX's dynamic_update_slice would clamp a start."""
    a = _host(x).astype(np.int64)
    if a.size and (a.min() < 0 or a.max() >= hi):
        raise ValueError(f"{what} must lie in [0, {hi}); got values in [{a.min()}, {a.max()}]")
    return a


def init_kv_cache(cfg: LlamaConfig, batch: int, max_len: int, *,
                  device: str | torch.device = "cuda") -> dict:
    """Zeroed cache. k/v: [n_layers, kv_h, b, max_len, hd] in cfg.dtype:
    heads first, where the reference's is [n_layers, b, max_len, kv_h, hd],
    so that a block of positions of a tile of rows is a strided view the
    attention's batched products read in place (the page pool's layout)."""
    shape = (cfg.num_hidden_layers, cfg.kv_heads, batch, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=cfg.dtype, device=device),
            "v": torch.zeros(shape, dtype=cfg.dtype, device=device)}


# ---------------------------------------------------------------------------
# Fixed-shape building blocks
# ---------------------------------------------------------------------------

def _rows(fn: Callable, tile: int, *xs: torch.Tensor):
    """`fn` over tiles of `tile` rows of each x (row-aligned), the last tile
    padded with zeros: every call of `fn` sees the same shapes. Returns fn's
    outputs (a tuple when fn returns one) cut back to the rows given."""
    n = xs[0].shape[0]
    n_pad = -(-n // tile) * tile
    if n_pad != n:
        xs = tuple(torch.cat([x, x.new_zeros((n_pad - n,) + tuple(x.shape[1:]))]) for x in xs)
    outs = [fn(*(x[i:i + tile] for x in xs)) for i in range(0, n_pad, tile)]
    single = not isinstance(outs[0], tuple)
    if single:
        outs = [(o,) for o in outs]
    joined = tuple((parts[0] if len(parts) == 1 else torch.cat(parts))[:n]
                   for parts in zip(*outs))
    return joined[0] if single else joined


def _qkv(layer: Params, cfg: LlamaConfig):
    """Row-wise prologue of a layer: x [T, d], cos/sin [T, hd] ->
    q [T, h, hd], k / v [T, kv_h, hd] (rms_norm -> projections -> RoPE, the
    reference's composition)."""
    dt, hd = cfg.dtype, cfg.head_dim

    def fn(x, cos, sin):
        t = x.shape[0]
        hidden = rms_norm(x, layer["input_norm"], cfg.rms_norm_eps)
        q = (hidden @ layer["attn.wq"].to(dt)).view(t, 1, -1, hd)
        k = (hidden @ layer["attn.wk"].to(dt)).view(t, 1, -1, hd)
        v = (hidden @ layer["attn.wv"].to(dt)).view(t, 1, -1, hd)
        q, k = apply_rope(q, k, cos[:, None], sin[:, None])
        return q[:, 0], k[:, 0], v[:, 0]

    return fn


def _post(layer: Params, cfg: LlamaConfig):
    """Row-wise epilogue of a layer: out-projection, residual, the MLP."""
    dt = cfg.dtype

    def fn(x, attn):
        x = x + attn.reshape(x.shape[0], -1) @ layer["attn.wo"].to(dt)
        return llama.mlp_block(layer, x, cfg)

    return fn


def _head(params: Params, x: torch.Tensor, cfg: LlamaConfig) -> torch.Tensor:
    """final norm -> lm_head on [n, d] rows in ROW_TILE tiles -> fp32 [n, V]."""
    return _rows(lambda h: llama.lm_head(params, llama.final_norm(params, h, cfg), cfg),
                 ROW_TILE, x)


BlockFn = Callable[[int], tuple[torch.Tensor, torch.Tensor, torch.Tensor]]


def _bmm32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a @ b (batched) with fp32 sums: on a card, half-precision operands go
    to the tensor cores as they are (`out_dtype`); elsewhere both are
    widened. Either way the products of the operands' values are summed in
    fp32, the exact op's arithmetic."""
    if a.is_cuda and a.dtype != torch.float32:
        return torch.bmm(a, b, out_dtype=torch.float32)
    return torch.bmm(a.float(), b.float())


def _attend(q: torch.Tensor, block: BlockFn, n_blocks: int, n_kv: int,
            q_pos: torch.Tensor | None = None, length: int | None = None) -> torch.Tensor:
    """Exact attention of one query tile over kv blocks, in order.

    q: [R, Sq, h, hd]; block(j) -> (k, v [n_kv, R, KV_BLOCK, hd] (a strided
    view whose two leading dims merge is read in place), mask [R, KV_BLOCK]
    0/1) for positions [j * KV_BLOCK, (j + 1) * KV_BLOCK); q_pos: [R, Sq]
    slot positions of the
    queries for the causal predicate (None: visibility is the mask alone,
    the decode step). `length`: the kv length of the reference's call; a
    query that sees no key gets, as there, the mean of v over [0, length)
    (a pad position's unread value, which an int8 page's scale does read).

    The exact op's rounding points: scores of (q * scale) in q's dtype
    against k, summed in fp32; a first pass takes each query's max and
    softmax denominator over the blocks (online, in fp32), a second rounds
    each normalized weight to v's dtype and sums weights @ v in fp32; one
    cast at the end. The q heads of a kv head are rows of one product (GQA
    without repeating k / v). A block masked for every query changes no bit
    (module docstring), so `n_blocks` may cover more than the visible span.
    """
    r, sq, h, hd = q.shape
    n_rep = h // n_kv
    rows = n_rep * sq                                  # queries a (row, kv head)
    g = n_kv * r
    qg = ((q * hd ** -0.5).view(r, sq, n_kv, n_rep, hd).permute(2, 0, 3, 1, 4)
          .reshape(g, rows, hd))

    def per_row(t):                                    # [R, X] -> [1, R, 1, X]
        return t[None, :, None, :]

    m = torch.full((g, rows), NEG_INF, dtype=torch.float32, device=q.device)
    denom = torch.zeros((g, rows), dtype=torch.float32, device=q.device)
    qp = None if q_pos is None else per_row(q_pos[:, None, :].expand(r, n_rep, sq)
                                            .reshape(r, rows)).transpose(-1, -2)
    scores, values = [], []
    for j in range(n_blocks):
        kb, vb, mb = block(j)
        s = _bmm32(qg, kb.reshape(g, KV_BLOCK, hd).transpose(1, 2))
        ok = per_row(mb).bool()
        k_pos = j * KV_BLOCK + torch.arange(KV_BLOCK, device=q.device)
        if qp is not None:
            ok = ok & (qp >= k_pos)
        s = torch.where(ok, s.view(n_kv, r, rows, KV_BLOCK), NEG_INF)
        if length is not None:
            s = torch.where(k_pos < length, s, -torch.inf)
        s = s.view(g, rows, KV_BLOCK)
        m_new = torch.maximum(m, s.amax(-1))
        denom = denom * torch.exp(m - m_new) + torch.exp(s - m_new[..., None]).sum(-1)
        m = m_new
        scores.append(s)
        values.append(vb)
    acc = torch.zeros((g, rows, hd), dtype=torch.float32, device=q.device)
    for s, vb in zip(scores, values):
        p = (torch.exp(s - m[..., None]) / denom[..., None]).to(vb.dtype)
        acc = acc + _bmm32(p, vb.reshape(g, KV_BLOCK, hd))
    out = acc.view(n_kv, r, n_rep, sq, hd).permute(1, 3, 0, 2, 4)
    return out.reshape(r, sq, h, hd).to(q.dtype)


def _n_blocks(last_pos: int) -> int:
    """Blocks that cover slot positions [0, last_pos]."""
    return last_pos // KV_BLOCK + 1


def _pad_block(x: torch.Tensor, start: int, dim: int) -> torch.Tensor:
    """Positions [start, start + KV_BLOCK) of x along `dim`, zero-padded
    past its end."""
    blk = x.narrow(dim, start, min(KV_BLOCK, max(x.shape[dim] - start, 0)))
    short = KV_BLOCK - blk.shape[dim]
    if short:
        shape = list(blk.shape)
        shape[dim] = short
        blk = torch.cat([blk, blk.new_zeros(shape)], dim)
    return blk


def _dense_blocks(ck: torch.Tensor, cv: torch.Tensor, kv_mask: torch.Tensor) -> BlockFn:
    """Blocks of dense cache rows ck / cv [kv_h, R, L, hd], kv_mask [R, L]:
    views, but for a block past the row's end."""
    def block(j):
        s = j * KV_BLOCK
        return _pad_block(ck, s, 2), _pad_block(cv, s, 2), _pad_block(kv_mask, s, 1)
    return block


def _row_tiles(n: int):
    """(start, stop) of each ROW_TILE tile over n rows (the last may be
    short: its blocks and queries are padded)."""
    return [(i, min(i + ROW_TILE, n)) for i in range(0, n, ROW_TILE)]


def _pad_rows(x: torch.Tensor, rows: int, dim: int = 0) -> torch.Tensor:
    """x with `rows` entries along `dim`, zero-padded."""
    short = rows - x.shape[dim]
    if not short:
        return x
    shape = list(x.shape)
    shape[dim] = short
    return torch.cat([x, x.new_zeros(shape)], dim)


def _attend_rows(q: torch.Tensor, block_rows: Callable[[int, int], BlockFn],
                 n_blocks: int, n_kv: int) -> torch.Tensor:
    """Decode attention of q [R, 1, h, hd] in tiles of ROW_TILE rows;
    block_rows(a, b) gives the blocks of rows [a, b) padded to ROW_TILE
    rows (pad rows fully masked)."""
    outs = []
    for a, b in _row_tiles(q.shape[0]):
        outs.append(_attend(_pad_rows(q[a:b], ROW_TILE), block_rows(a, b), n_blocks,
                            n_kv)[:b - a])
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _attend_prefill(q: torch.Tensor, q_pos: np.ndarray, block: BlockFn, length: int,
                    first_seen: int, n_kv: int) -> torch.Tensor:
    """Causal attention of one row's queries q [C, h, hd] at slot positions
    q_pos [C] (host, ascending), in query tiles of PREFILL_TILE, over a row
    of `length` positions whose first real one is `first_seen`. A tile
    holding a query that sees no key (a left pad) visits every block of the
    row, for that query's mean (_attend); any other tile stops at its
    causal edge."""
    c = q.shape[0]
    qp = torch.as_tensor(q_pos, device=q.device)
    outs = []
    for a in range(0, c, PREFILL_TILE):
        b = min(a + PREFILL_TILE, c)
        qt = _pad_rows(q[a:b], PREFILL_TILE)[None]
        pt = _pad_rows(qp[a:b], PREFILL_TILE)[None]
        last = length - 1 if q_pos[a] < first_seen else int(q_pos[b - 1])
        outs.append(_attend(qt, block, _n_blocks(last), n_kv, pt, length)[0, :b - a])
    return torch.cat(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# Sampling
# ---------------------------------------------------------------------------

def _top_p_mask(logits: torch.Tensor, top_p) -> torch.Tensor:
    """Nucleus filter: keep the smallest descending-sorted prefix whose
    cumulative probability reaches `top_p`; everything else to -inf. The
    keep rule is `mass BEFORE the token < top_p`, so the argmax always
    survives. `top_p`: a float or a tensor broadcasting against [..., 1]."""
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    probs = torch.softmax(sorted_desc, dim=-1)
    before = torch.cumsum(probs, dim=-1) - probs
    keep = before < top_p
    cutoff = torch.where(keep, sorted_desc, torch.inf).amin(-1, keepdim=True)
    return torch.where(logits < cutoff, -torch.inf, logits)


def _top_k_mask(logits: torch.Tensor, top_k: torch.Tensor) -> torch.Tensor:
    """Everything below each row's k-th largest value to -inf (rows with
    top_k <= 0 untouched). logits [R, V], top_k [R]."""
    vocab = logits.shape[-1]
    sorted_desc = torch.sort(logits, dim=-1, descending=True).values
    kth = sorted_desc.gather(1, (top_k.clamp(1, vocab) - 1)[:, None].long())
    return torch.where((top_k > 0)[:, None] & (logits < kth), -torch.inf, logits)


def filter_logits(logits: torch.Tensor, temperature: torch.Tensor, top_k: torch.Tensor,
                  top_p: torch.Tensor) -> torch.Tensor:
    """Temperature, top-k and top-p of each row [R, V] by its own knobs: the
    support a sampled row draws from (-inf outside it)."""
    safe_t = torch.where(temperature > 0.0, temperature, torch.ones_like(temperature))
    filtered = _top_k_mask(logits / safe_t[:, None], top_k)
    return torch.where((top_p < 1.0)[:, None], _top_p_mask(filtered, top_p[:, None]), filtered)


def _gumbel(generator: torch.Generator, vocab: int, device) -> torch.Tensor:
    """One row of Gumbel noise from `generator` (uniform in [tiny, 1))."""
    u = torch.rand(vocab, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(torch.finfo(torch.float32).tiny)))


def _sample_tile(logits, temperature, top_k, top_p, generators):
    greedy = logits.argmax(-1)
    sampled_rows = [i for i, t in enumerate(temperature.tolist()) if t > 0.0]
    if not sampled_rows:
        return greedy
    tt = temperature.to(logits.device)
    filtered = filter_logits(logits, tt, top_k.to(logits.device), top_p.to(logits.device))
    noise = torch.zeros_like(logits)
    for i in sampled_rows:
        if generators[i] is None:
            raise ValueError(f"row {i} samples (temperature > 0) but has no generator")
        noise[i] = _gumbel(generators[i], logits.shape[-1], logits.device)
    return torch.where(tt > 0.0, (filtered + noise).argmax(-1), greedy)


@torch.no_grad()
def sample_rowwise(logits: torch.Tensor, temperature, top_k, top_p,
                   generators: Generators) -> torch.Tensor:
    """[R, V] fp32 logits + [R] per-row knobs + one generator a row (None
    for a greedy row) -> [R] int64 tokens, in ROW_TILE tiles.

    Greedy rows take the argmax of the raw logits. A sampled row divides by
    its temperature, applies its top-k and top-p filters, and takes the
    argmax of the filtered logits plus Gumbel noise drawn from its own
    generator: one draw of V values a sampled token, so a request's stream
    depends on its seed alone, never on its co-tenants.
    """
    r = logits.shape[0]
    temperature = torch.as_tensor(temperature, dtype=torch.float32).cpu()
    top_k = torch.as_tensor(top_k, dtype=torch.int64).cpu()
    top_p = torch.as_tensor(top_p, dtype=torch.float32).cpu()
    gens = list(generators) + [None] * (-(-r // ROW_TILE) * ROW_TILE - r)
    outs = []
    for a, b in _row_tiles(r):
        pad = ROW_TILE - (b - a)
        outs.append(_sample_tile(
            _pad_rows(logits[a:b], ROW_TILE),
            _pad_rows(temperature[a:b], ROW_TILE), _pad_rows(top_k[a:b], ROW_TILE),
            torch.cat([top_p[a:b], torch.ones(pad)]) if pad else top_p[a:b],
            gens[a:a + ROW_TILE])[:b - a])
    return torch.cat(outs) if len(outs) > 1 else outs[0]


def _sample(logits: torch.Tensor, gen: GenerationConfig, generators: Generators) -> torch.Tensor:
    """generate()'s sampler: sample_rowwise with the batch's shared knobs
    (the same arithmetic as a served request's)."""
    r = logits.shape[0]
    return sample_rowwise(logits, [gen.temperature] * r, [gen.top_k] * r, [gen.top_p] * r,
                          generators)


# ---------------------------------------------------------------------------
# Layers over a cache
# ---------------------------------------------------------------------------

def _embed_rope(params, ids, positions, cfg):
    x = llama.embed(params, ids, cfg)
    cos, sin = rope_cos_sin(positions, cfg.head_dim, cfg.rope_theta, dtype=cfg.dtype)
    return x, cos, sin


def _prefill_rows(params: Params, cfg: LlamaConfig, ids: torch.Tensor, positions: torch.Tensor,
                  q_pos: np.ndarray, write: Callable, blocks: Callable, length: int,
                  first_seen: Sequence[int]) -> torch.Tensor:
    """The layers over prompt tokens ids [b, C] at rope `positions` [b, C]
    and slot positions q_pos [C] (host): each layer computes q/k/v in
    PREFILL_TILE tiles, `write(i, k, v)` stores layer i's k/v [b, C, kv_h,
    hd], then each row attends causally over `blocks(i, row)`, a row of
    `length` positions whose first real one is first_seen[row]. Returns the
    last layer's hidden states [b, C, d]."""
    b, c = ids.shape
    x, cos, sin = _embed_rope(params, ids, positions, cfg)
    x = x.reshape(b * c, -1)
    cos, sin = cos.reshape(b * c, -1), sin.reshape(b * c, -1)
    for i, layer in enumerate(_layers(params, cfg)):
        q, k, v = _rows(_qkv(layer, cfg), PREFILL_TILE, x, cos, sin)
        write(i, k.view(b, c, *k.shape[1:]), v.view(b, c, *v.shape[1:]))
        q = q.view(b, c, *q.shape[1:])
        attn = torch.cat([_attend_prefill(q[r], q_pos, blocks(i, r), length, first_seen[r],
                                          cfg.kv_heads) for r in range(b)])
        x = _rows(_post(layer, cfg), PREFILL_TILE, x, attn)
    return x.view(b, c, -1)


def _first_seen(mask: torch.Tensor) -> list[int]:
    """Each row's first position with mask 1 (its length when none)."""
    m = _host(mask).astype(bool)
    return [int(r.argmax()) if r.any() else len(r) for r in m]


def _decode_rows(params: Params, cfg: LlamaConfig, token: torch.Tensor, pos: torch.Tensor,
                 last_pos: int, write: Callable, block_rows: Callable) -> torch.Tensor:
    """The layers over one token a row (token / pos [R]): q/k/v in ROW_TILE
    tiles, `write(i, k, v)` stores layer i's k/v [R, kv_h, hd], attention
    over `block_rows(i, a, b)` for blocks 0..last_pos. Returns fp32 logits
    [R, V]."""
    x, cos, sin = _embed_rope(params, token[:, None], pos[:, None], cfg)
    x, cos, sin = x[:, 0], cos[:, 0], sin[:, 0]
    n_blocks = _n_blocks(last_pos)
    for i, layer in enumerate(_layers(params, cfg)):
        q, k, v = _rows(_qkv(layer, cfg), ROW_TILE, x, cos, sin)
        write(i, k, v)
        attn = _attend_rows(q[:, None], lambda a, b, i=i: block_rows(i, a, b), n_blocks,
                            cfg.kv_heads)
        x = _rows(_post(layer, cfg), ROW_TILE, x, attn[:, 0])
    return _head(params, x, cfg)


def _dev_long(x, device) -> torch.Tensor:
    return torch.as_tensor(_host(x), dtype=torch.int64, device=device)


@torch.no_grad()
def forward_with_cache(params: Params, input_ids, cache: dict, positions, write_pos,
                       kv_mask: torch.Tensor, cfg: LlamaConfig, causal: bool = True,
                       last_only: bool = False) -> tuple[torch.Tensor, dict]:
    """Embed -> cached layers -> final norm -> fp32 logits [b, s, V]; the
    cache is updated in place and returned.

    `causal=True` is the prefill contract: the block is the entire visible
    history, written at slot 0 (`write_pos` must be 0). `causal=False` is
    the decode step: s == 1, every row writes slot `write_pos` and attends
    over its cache row gated by kv_mask alone. `last_only` projects the
    final position only."""
    dev = _device(params)
    ids = _dev_long(input_ids, dev)
    check_ids(ids, cfg.vocab_size)
    b, s = ids.shape
    pos = _dev_long(positions, dev)
    max_len = cache["k"].shape[3]
    wp = int(write_pos)
    if causal:
        if wp != 0:
            raise ValueError("causal (prefill) forward writes from slot 0; got write_pos "
                             f"{wp}")
        _check_range([s - 1], max_len, "prompt positions")
        x = _prefill_dense(params, cfg, ids, pos, cache, kv_mask)
        x = x[:, -1:] if last_only else x
        return _head(params, x.reshape(-1, x.shape[-1]), cfg).view(b, x.shape[1], -1), cache
    if s != 1:
        raise ValueError(f"decode forward takes one token a row, got {s}")
    _check_range([wp], max_len, "write_pos")
    logits = _decode_dense(params, cfg, ids[:, 0], pos[:, 0], torch.full((b,), wp), cache,
                           kv_mask)
    return logits[:, None], cache


def _prefill_dense(params, cfg, ids, pos, cache, kv_mask):
    """Prefill rows [b, P] from slot 0 into a dense cache (in place)."""
    p = ids.shape[1]

    def write(i, k, v):
        cache["k"][i, :, :, :p] = k.permute(2, 0, 1, 3)
        cache["v"][i, :, :, :p] = v.permute(2, 0, 1, 3)

    def blocks(i, r):
        return _dense_blocks(cache["k"][i, :, r:r + 1], cache["v"][i, :, r:r + 1],
                             kv_mask[r:r + 1])

    return _prefill_rows(params, cfg, ids, pos, np.arange(p), write, blocks, p,
                         _first_seen(kv_mask[:, :p]))


# id of a state tensor (a cache's or a pool's k) -> {signature: _Graph},
# dropped with the tensor
_GRAPHS: dict[int, dict] = {}


class _Graph:
    """One captured decode forward: static input buffers, the graph, and
    its fp32 logits."""

    def __init__(self, run: Callable, inputs: list[torch.Tensor]):
        self.inputs = [t.clone() for t in inputs]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):   # warm-up: its kv writes are this tick's own
            run(*self.inputs)
        torch.cuda.current_stream().wait_stream(side)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.logits = run(*self.inputs)

    def __call__(self, inputs: list[torch.Tensor]) -> torch.Tensor:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(x)
        self.graph.replay()
        return self.logits.clone()


def _replay(state: torch.Tensor, signature: tuple, run: Callable,
            inputs: list[torch.Tensor]) -> torch.Tensor:
    """run(*inputs) -> logits, captured once per (state, signature) as a CUDA
    graph and replayed (eager off a card or with CUDA_GRAPHS off). `run`
    reads only `inputs` and tensors that live as long as `state`; the
    signature names everything else the capture fixed."""
    if not (CUDA_GRAPHS and state.is_cuda):
        return run(*inputs)
    graphs = _GRAPHS.get(id(state))
    if graphs is None:
        graphs = _GRAPHS[id(state)] = {}
        weakref.finalize(state, _GRAPHS.pop, id(state), None)
    g = graphs.get(signature)
    if g is None:
        g = graphs[signature] = _Graph(run, inputs)
        g.graph.replay()
        return g.logits.clone()
    return g(inputs)


def _decode_dense(params, cfg, token, pos, write_pos, cache, kv_mask):
    """One decode step over dense cache rows; write_pos [R] host ints."""
    wp = _host(write_pos).astype(np.int64)
    dev = cache["k"].device
    last = int(wp.max())

    def run(tok_d, pos_d, wp_d):
        rows = torch.arange(tok_d.shape[0], device=dev)

        def write(i, k, v):
            cache["k"][i, :, rows, wp_d] = k.transpose(0, 1)
            cache["v"][i, :, rows, wp_d] = v.transpose(0, 1)

        def block_rows(i, a, b):
            return _dense_blocks(_pad_rows(cache["k"][i, :, a:b], ROW_TILE, 1),
                                 _pad_rows(cache["v"][i, :, a:b], ROW_TILE, 1),
                                 _pad_rows(kv_mask[a:b], ROW_TILE))

        return _decode_rows(params, cfg, tok_d, pos_d, last, write, block_rows)

    signature = ("dense", len(wp), _n_blocks(last), kv_mask.data_ptr(),
                 params["lm_head"].data_ptr())
    return _replay(cache["k"], signature, run, [
        torch.as_tensor(token, dtype=torch.int64).to(dev),
        torch.as_tensor(pos, dtype=torch.int64).to(dev), torch.as_tensor(wp).to(dev)])


# ---------------------------------------------------------------------------
# generate
# ---------------------------------------------------------------------------

def _generators(generator, b: int) -> list:
    if generator is None or isinstance(generator, torch.Generator):
        return [generator] * b
    gens = list(generator)
    if len(gens) != b:
        raise ValueError(f"{len(gens)} generators for {b} rows")
    return gens


@torch.no_grad()
def generate(params: Params, input_ids, attention_mask, cfg: LlamaConfig, gen: GenerationConfig,
             generator: torch.Generator | Generators | None = None) -> dict:
    """Batched generation from LEFT-padded prompts.

    input_ids / attention_mask: [b, P] (mask 0 = pad) on any device; the
    work runs on the parameters' device. `generator`: one torch.Generator
    on that device for the batch (rows draw in order), or one a row; only
    sampling (temperature > 0) reads it. Returns {"tokens": [b,
    max_new_tokens] int64 (pad_token_id after eos), "done": [b] bool}.
    Params are the canonical layout (the trainer's or `compute_params`).
    """
    dev = _device(params)
    ids = _dev_long(input_ids, dev)
    check_ids(ids, cfg.vocab_size)
    mask = torch.as_tensor(_host(attention_mask), dtype=torch.int32, device=dev)
    b, prompt_len = ids.shape
    gens = _generators(generator, b)
    max_len = prompt_len + gen.max_new_tokens
    positions = (mask.cumsum(1) - 1).clamp_min(0)

    cache = init_kv_cache(cfg, b, max_len, device=dev)
    kv_mask = F.pad(mask, (0, gen.max_new_tokens))
    x = _prefill_dense(params, cfg, ids, positions, cache, kv_mask)
    token = _sample(_head(params, x[:, -1], cfg), gen, gens)

    pos = positions[:, -1] + 1
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    out = []
    for t in range(gen.max_new_tokens - 1):
        write_pos = prompt_len + t
        kv_mask[:, write_pos] = 1
        logits = _decode_dense(params, cfg, token, pos, np.full(b, write_pos), cache, kv_mask)
        nxt = _sample(logits, gen, gens)
        out.append(torch.where(done, gen.pad_token_id, token))
        if gen.eos_token_id is not None:
            done = done | (token == gen.eos_token_id)
        token = torch.where(done, token, nxt)     # freeze finished rows
        pos = pos + 1
    # the T-th token needs no forward pass of its own
    out.append(torch.where(done, gen.pad_token_id, token))
    if gen.eos_token_id is not None:
        done = done | (token == gen.eos_token_id)
    return {"tokens": torch.stack(out, 1), "done": done}


# ---------------------------------------------------------------------------
# continuous batching over the dense slot cache (serve/slots.py)
# ---------------------------------------------------------------------------

@torch.no_grad()
def prefill_prompt(params: Params, input_ids, attention_mask, cfg: LlamaConfig,
                   max_len: int) -> dict:
    """Prefill LEFT-padded prompts [b, P] into fresh max_len-sized cache
    rows. Returns {"logits": [b, V] fp32 last-position logits, "cache": k/v
    [L, kv_h, b, max_len, hd] with the prompt's kv at [0, P), "kv_mask":
    [b, max_len] int32, "next_pos": [b] rope position of the first
    generated token}."""
    dev = _device(params)
    ids = _dev_long(input_ids, dev)
    check_ids(ids, cfg.vocab_size)
    b, prompt_len = ids.shape
    if prompt_len > max_len:
        raise ValueError(f"prompt bucket {prompt_len} exceeds cache max_len {max_len}")
    mask = torch.as_tensor(_host(attention_mask), dtype=torch.int32, device=dev)
    positions = (mask.cumsum(1) - 1).clamp_min(0)
    cache = init_kv_cache(cfg, b, max_len, device=dev)
    kv_mask = F.pad(mask, (0, max_len - prompt_len))
    x = _prefill_dense(params, cfg, ids, positions, cache, kv_mask)
    return {"logits": _head(params, x[:, -1], cfg), "cache": cache, "kv_mask": kv_mask,
            "next_pos": positions[:, -1] + 1}


@torch.no_grad()
def decode_step(params: Params, token, cache: dict, pos, write_pos, kv_mask: torch.Tensor,
                generators: Generators, temperature, top_k, top_p, cfg: LlamaConfig) -> dict:
    """One continuous-batching decode tick over every slot row.

    token / pos / write_pos: [S] ints (host or device); cache: k/v [L, kv_h,
    S, max_len, hd]; kv_mask [S, max_len]; generators: one a row (None
    for greedy and free rows); temperature / top_k / top_p: [S] knobs.
    Each row mirrors one generate() step: mark write_pos valid, write the
    token's kv there, attend, sample. The cache and kv_mask are updated in
    place. Returns {"token": [S] int64 next tokens, "cache", "kv_mask",
    "logits": [S, V] fp32, what the tokens were sampled from}."""
    dev = _device(params)
    tok = _dev_long(token, dev)
    check_ids(tok, cfg.vocab_size)
    s = tok.shape[0]
    wp = _check_range(write_pos, cache["k"].shape[3], "write_pos")
    kv_mask[torch.arange(s, device=dev), torch.as_tensor(wp, device=dev)] = 1
    logits = _decode_dense(params, cfg, tok, _dev_long(pos, dev), wp, cache, kv_mask)
    nxt = sample_rowwise(logits, temperature, top_k, top_p, generators)
    return {"token": nxt, "cache": cache, "kv_mask": kv_mask, "logits": logits}


@torch.no_grad()
def write_slot(cache: dict, kv_mask: torch.Tensor, slot: int, row_cache: dict,
               row_kv_mask: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Copy one prefilled request (`prefill_prompt` output, b == 1) into
    slot row `slot` of the serving cache, in place."""
    _check_range([slot], kv_mask.shape[0], "slot")
    n = row_cache["k"].shape[3]
    cache["k"][:, :, slot, :n] = row_cache["k"][:, :, 0]
    cache["v"][:, :, slot, :n] = row_cache["v"][:, :, 0]
    kv_mask[slot, :n] = row_kv_mask[0]
    kv_mask[slot, n:] = 0
    return cache, kv_mask


# ---------------------------------------------------------------------------
# the page pool (serve/pages.py)
# ---------------------------------------------------------------------------
#
# A pool backs the logical [max_slots, max_len] rows with fixed-size pages
# and a host-side slot -> page table. The logical view a slot sees is still
# [max_len] = pages_per_slot * page_size, gathered a block at a time, so fp
# pages give the dense path's bits. int8 pages store one fp32 scale per
# (layer, page, kv_head) and dequantize on read, in fp32, before the cast
# to the compute dtype.

def _num_pages(pool: dict) -> int:
    """Physical pages of a pool, the garbage page included."""
    return pool["k"].shape[2]


def _page_size(pool: dict) -> int:
    return pool["k"].shape[3]


def init_page_pool(cfg: LlamaConfig, num_pages: int, page_size: int, quant: str = "fp", *,
                   device: str | torch.device = "cuda") -> dict:
    """Zeroed pool. k/v: [n_layers, kv_h, num_pages + 1, page_size, hd]
    (the reference's is [n_layers, num_pages + 1, page_size, kv_h, hd]):
    ONE extra garbage page at index `num_pages`, where released and
    inactive slots point every logical page; heads first, so that a block
    gathers as whole contiguous pages into the layout the attention's
    batched products read. int8 pools carry k_scale / v_scale: [n_layers,
    num_pages + 1, kv_h] fp32."""
    shape = (cfg.num_hidden_layers, cfg.kv_heads, num_pages + 1, page_size, cfg.head_dim)
    dt = torch.int8 if quant == "int8" else cfg.dtype
    pool = {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device)}
    if quant == "int8":
        sshape = (cfg.num_hidden_layers, num_pages + 1, cfg.kv_heads)
        pool["k_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
        pool["v_scale"] = torch.zeros(sshape, dtype=torch.float32, device=device)
    return pool


def quant_page_block(x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """fp -> int8 against a per-(page, kv_head) scale broadcast over the
    block: round(x * (127 / scale)) (half to even, the product order of the
    reference), saturating at +-127."""
    q = torch.round(x.float() * (127.0 / scale))
    return q.clamp(-127, 127).to(torch.int8)


def dequant_page_block(q: torch.Tensor, scale: torch.Tensor, dtype) -> torch.Tensor:
    """int8 -> fp32 against the per-page scale, then the compute-dtype cast."""
    return (q.float() * (scale / 127.0)).to(dtype)


def _block_amax(x: torch.Tensor, dims) -> torch.Tensor:
    return x.float().abs().amax(dim=dims).clamp_min(_SCALE_FLOOR)


def _is_int8(pool: dict) -> bool:
    return pool["k"].dtype == torch.int8


def _gather_pages(pool_k, pool_v, sc_k, sc_v, page_table: torch.Tensor, dtype):
    """Logical kv rows from one layer's pool in one gather each: [R, P] page
    indices -> heads first [kv_h, R, P * page_size, hd] in the compute dtype
    (int8 pages dequantized in fp32 on the way)."""
    kvh, _, page, hd = pool_k.shape
    r, p = page_table.shape
    flat = page_table.reshape(-1)
    # whole pages (page x hd contiguous) a head: index_select copies them as rows
    gk = pool_k.view(kvh, -1, page * hd).index_select(1, flat).view(kvh, r, p, page, hd)
    gv = pool_v.view(kvh, -1, page * hd).index_select(1, flat).view(kvh, r, p, page, hd)
    if sc_k is not None:
        gk = dequant_page_block(gk, sc_k[page_table].permute(2, 0, 1)[..., None, None], dtype)
        gv = dequant_page_block(gv, sc_v[page_table].permute(2, 0, 1)[..., None, None], dtype)
    return gk.reshape(kvh, r, p * page, hd), gv.reshape(kvh, r, p * page, hd)


def _paged_blocks(pool: dict, layer: int, page_table: torch.Tensor, kv_mask: torch.Tensor,
                  garbage: int, dtype) -> BlockFn:
    """Blocks (heads first) of the logical rows page_table [R,
    pages_per_slot] (device) over kv_mask [R, max_len]; pages past the
    row's end read the garbage page (masked)."""
    page = _page_size(pool)
    if KV_BLOCK % page:
        raise ValueError(f"page_size {page} must divide the attention block {KV_BLOCK}")
    per = KV_BLOCK // page
    sc_k = pool["k_scale"][layer] if "k_scale" in pool else None
    sc_v = pool["v_scale"][layer] if "v_scale" in pool else None

    def block(j):
        pages = page_table[:, j * per:(j + 1) * per]
        short = per - pages.shape[1]
        if short:
            pages = torch.cat([pages, pages.new_full((pages.shape[0], short), garbage)], 1)
        gk, gv = _gather_pages(pool["k"][layer], pool["v"][layer], sc_k, sc_v, pages, dtype)
        return gk, gv, _pad_block(kv_mask, j * KV_BLOCK, 1)

    return block


@torch.no_grad()
def write_pages(pool: dict, kv_mask: torch.Tensor, slot: int, page_rows, row_cache: dict,
                row_kv_mask: torch.Tensor) -> tuple[dict, torch.Tensor]:
    """Store one prefilled request in its physical pages, in place: the
    paged counterpart of `write_slot`. `row_cache` is a `prefill_prompt`
    result at max_len == the bucket (k/v [L, kv_h, 1, bucket, hd], bucket a
    multiple of page_size); `page_rows` the [bucket / page_size] pages the
    slot owns for it. The logical mask row is rewritten whole."""
    n_layers, kvh, _, bucket, hd = row_cache["k"].shape
    pages = _dev_long(page_rows, pool["k"].device)
    _check_range(pages, _num_pages(pool), "page rows")
    _check_range([slot], kv_mask.shape[0], "slot")
    n = pages.shape[0]
    page = bucket // n
    for name in ("k", "v"):
        blocks = row_cache[name][:, :, 0].reshape(n_layers, kvh, n, page, hd)
        if _is_int8(pool):
            scale = _block_amax(blocks, (3, 4))                 # [L, kvh, n]
            pool[f"{name}_scale"][:, pages] = scale.transpose(1, 2)
            blocks = quant_page_block(blocks, scale[..., None, None])
        pool[name][:, :, pages] = blocks
    kv_mask[slot, :bucket] = row_kv_mask[0]
    kv_mask[slot, bucket:] = 0
    return pool, kv_mask


@torch.no_grad()
def reset_kv_mask_row(kv_mask: torch.Tensor, slot: int) -> torch.Tensor:
    """Zero logical row `slot` (a chunked prefill writes it incrementally)."""
    _check_range([slot], kv_mask.shape[0], "slot")
    kv_mask[slot] = 0
    return kv_mask


@torch.no_grad()
def copy_page(pool: dict, src: int, dst: int) -> dict:
    """Clone physical page `src` into `dst` across every layer (scales
    included): the copy-on-write fork of prefix caching."""
    _check_range([src, dst], _num_pages(pool), "page")
    for name in ("k", "v"):
        pool[name][:, :, dst] = pool[name][:, :, src]
        if f"{name}_scale" in pool:
            pool[f"{name}_scale"][:, dst] = pool[f"{name}_scale"][:, src]
    return pool


@torch.no_grad()
def set_kv_mask_row(kv_mask: torch.Tensor, slot: int, row) -> torch.Tensor:
    """Rewrite logical row `slot` whole from a host-built [1, max_len] row."""
    _check_range([slot], kv_mask.shape[0], "slot")
    kv_mask[slot] = torch.as_tensor(_host(row), dtype=kv_mask.dtype,
                                    device=kv_mask.device).reshape(-1)
    return kv_mask


def _paged_write_token(pool_k, sc_k, x1: torch.Tensor, w_page: torch.Tensor,
                       w_off: torch.Tensor) -> None:
    """Scatter kv rows x1 [N, kv_h, hd] (one a token) into (w_page, w_off)
    of one layer's pool [kv_h, pages, page, hd]. int8: offset 0 claims the
    page and sets its scale from this token's absmax; later offsets saturate
    against the page's scale."""
    if sc_k is None:
        pool_k[:, w_page, w_off] = x1.transpose(0, 1)
        return
    amax = _block_amax(x1, -1)                                   # [N, kvh]
    scale = torch.where((w_off == 0)[:, None], amax, sc_k[w_page].clamp_min(_SCALE_FLOOR))
    sc_k[w_page] = scale
    pool_k[:, w_page, w_off] = quant_page_block(x1, scale[:, :, None]).transpose(0, 1)


@torch.no_grad()
def paged_decode_step(params: Params, token, pool: dict, page_table, pos, write_pos,
                      kv_mask: torch.Tensor, active, generators: Generators, temperature, top_k,
                      top_p, cfg: LlamaConfig) -> dict:
    """`decode_step` over the page pool. page_table: [S, pages_per_slot]
    physical page per logical page; active: [S] 0/1, the rows decoding.
    Inactive rows ride along: their kv writes go to the garbage page and
    their mask rows stay as they are (a slot mid chunked prefill owns live
    pages and mask spans). The pool and kv_mask are updated in place.
    Returns {"token": [S], "pool", "kv_mask", "logits": [S, V]}."""
    dev = _device(params)
    tok = _dev_long(token, dev)
    check_ids(tok, cfg.vocab_size)
    s = tok.shape[0]
    page = _page_size(pool)
    garbage = _num_pages(pool) - 1
    act = _host(active).astype(bool)
    wp = _check_range(write_pos, kv_mask.shape[1], "write_pos")
    table = _host(page_table).astype(np.int64)
    _check_range(table, garbage + 1, "page table")
    w_page = np.where(act, table[np.arange(s), wp // page], garbage)
    rows = torch.arange(s, device=dev)
    wpd = torch.as_tensor(wp, device=dev)
    kv_mask[rows, wpd] = torch.maximum(kv_mask[rows, wpd],
                                       torch.as_tensor(act, dtype=kv_mask.dtype, device=dev))
    int8 = _is_int8(pool)
    last = int(wp.max())

    def run(tok_d, pos_d, w_page_d, w_off_d, table_d):
        def write(i, k, v):
            _paged_write_token(pool["k"][i], pool["k_scale"][i] if int8 else None, k,
                               w_page_d, w_off_d)
            _paged_write_token(pool["v"][i], pool["v_scale"][i] if int8 else None, v,
                               w_page_d, w_off_d)

        def block_rows(i, a, b):   # pad rows read the garbage page, masked
            pad = ROW_TILE - (b - a)
            table_t = (torch.cat([table_d[a:b], table_d.new_full((pad, table_d.shape[1]),
                                                                 garbage)])
                       if pad else table_d[a:b])
            return _paged_blocks(pool, i, table_t, _pad_rows(kv_mask[a:b], ROW_TILE), garbage,
                                 cfg.dtype)

        return _decode_rows(params, cfg, tok_d, pos_d, last, write, block_rows)

    signature = ("paged", s, _n_blocks(last), kv_mask.data_ptr(), params["lm_head"].data_ptr())
    logits = _replay(pool["k"], signature, run, [
        tok, _dev_long(pos, dev), torch.as_tensor(w_page).to(dev),
        torch.as_tensor(wp % page).to(dev), torch.as_tensor(table).to(dev)])
    nxt = sample_rowwise(logits, temperature, top_k, top_p, generators)
    return {"token": nxt, "pool": pool, "kv_mask": kv_mask, "logits": logits}


def _paged_prefill(params, input_ids, attention_mask, positions, pool, page_table_row, slot,
                   kv_mask, write_start, cfg, write_fn):
    """Shared body of the chunk and span prefills: mark the span's mask,
    run the layers with `write_fn(layer, k, v, pages)` storing each
    layer's kv, attend over the slot's whole logical row; return the last
    position's logits."""
    dev = _device(params)
    ids = _dev_long(input_ids, dev)
    check_ids(ids, cfg.vocab_size)
    _, c = ids.shape
    garbage = _num_pages(pool) - 1
    w0 = int(write_start)
    _check_range([w0, w0 + c - 1], kv_mask.shape[1], "prefill span")
    _check_range([slot], kv_mask.shape[0], "slot")
    table = _dev_long(page_table_row, dev).reshape(1, -1)
    _check_range(table, garbage + 1, "page table")
    kv_mask[slot, w0:w0 + c] = torch.as_tensor(_host(attention_mask), dtype=kv_mask.dtype,
                                               device=dev).reshape(-1)
    row_mask = kv_mask[slot:slot + 1]

    def write(i, k, v):
        write_fn(i, k[0], v[0])

    def blocks(i, r):
        return _paged_blocks(pool, i, table, row_mask, garbage, cfg.dtype)

    x = _prefill_rows(params, cfg, ids, _dev_long(positions, dev), np.arange(w0, w0 + c),
                      write, blocks, kv_mask.shape[1], _first_seen(row_mask[:, :w0 + c]))
    return {"logits": _head(params, x[:, -1], cfg), "pool": pool, "kv_mask": kv_mask}


@torch.no_grad()
def paged_prefill_chunk(params: Params, input_ids, attention_mask, positions, pool: dict,
                        page_table_row, slot: int, kv_mask: torch.Tensor, write_start: int,
                        cfg: LlamaConfig) -> dict:
    """One prefill chunk of slot `slot`: tokens [1, C] (C a multiple of
    page_size) at logical span [write_start, write_start + C), their kv
    written as whole pages, each position attending causally over the
    slot's whole logical row. In place; returns {"logits": [1, V] of the
    last position, "pool", "kv_mask"}."""
    page = _page_size(pool)
    c = _host(input_ids).shape[1]
    w0 = int(write_start)
    if c % page or w0 % page:
        raise ValueError(f"chunk [{w0}, {w0 + c}) is not page-aligned (page {page})")
    dev = _device(params)
    chunk_pages = _dev_long(_host(page_table_row).reshape(-1)[w0 // page:(w0 + c) // page], dev)
    int8 = _is_int8(pool)

    def write_fn(i, k, v):
        for name, x in (("k", k), ("v", v)):
            blocks = x.reshape(c // page, page, *x.shape[1:])       # [C/page, page, kvh, hd]
            if int8:
                scale = _block_amax(blocks, (1, 3))                 # [C/page, kvh]
                pool[f"{name}_scale"][i, chunk_pages] = scale
                blocks = quant_page_block(blocks, scale[:, None, :, None])
            pool[name][i][:, chunk_pages] = blocks.permute(2, 0, 1, 3)

    return _paged_prefill(params, input_ids, attention_mask, positions, pool, page_table_row,
                          slot, kv_mask, w0, cfg, write_fn)


@torch.no_grad()
def paged_prefill_span(params: Params, input_ids, attention_mask, positions, pool: dict,
                       page_table_row, slot: int, kv_mask: torch.Tensor, write_start: int,
                       cfg: LlamaConfig) -> dict:
    """`paged_prefill_chunk` without page alignment: the tail a prefix-cache
    hit recomputes from its divergence point. Writes are per-token scatters
    into (page, offset) pairs. int8 pages follow the decode-write rule: a
    page whose offset-0 position lies inside the span is claimed by that
    token's absmax; a page entered mid-way keeps its scale and saturates."""
    page = _page_size(pool)
    c = _host(input_ids).shape[1]
    w0 = int(write_start)
    dev = _device(params)
    w_pos = np.arange(w0, w0 + c)
    table = _host(page_table_row).reshape(-1).astype(np.int64)
    w_page = torch.as_tensor(table[w_pos // page], device=dev)
    w_off_h = w_pos % page
    w_off = torch.as_tensor(w_off_h, device=dev)
    # index (within the span) of each token's page-offset-0 position: >= 0
    # iff the span claims that page
    first_idx = w_pos - w_off_h - w0
    in_span = torch.as_tensor(first_idx >= 0, device=dev)[:, None]
    first_idx = torch.as_tensor(np.clip(first_idx, 0, c - 1), device=dev)
    int8 = _is_int8(pool)

    def write_fn(i, k, v):
        for name, x in (("k", k), ("v", v)):
            pk = pool[name][i]
            if not int8:
                pk[:, w_page, w_off] = x.transpose(0, 1)
                continue
            sk = pool[f"{name}_scale"][i]
            amax = _block_amax(x, -1)                                # [C, kvh]
            # duplicate pages in this scatter all carry the same scale
            scale = torch.where(in_span, amax[first_idx], sk[w_page].clamp_min(_SCALE_FLOOR))
            sk[w_page] = scale
            pk[:, w_page, w_off] = quant_page_block(x, scale[:, :, None]).transpose(0, 1)

    return _paged_prefill(params, input_ids, attention_mask, positions, pool, page_table_row,
                          slot, kv_mask, w0, cfg, write_fn)
