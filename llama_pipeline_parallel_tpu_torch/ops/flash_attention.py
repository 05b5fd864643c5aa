"""Flash attention (FlashAttention-2 schedule) with a hand-written CUDA kernel
for each pass, as a `torch.autograd.Function`.

The counterpart of llama_pipeline_parallel_tpu/ops/flash_attention.py. The
three Pallas TPU kernels there become the CUDA kernels of
`csrc/flash_attention.cu` (forward, dq, dk/dv; see that file for the design
and what bounds it). The causal predicate and the segment test are evaluated
per tile inside the kernels, scores never exist in device memory, and memory
is O(L) per head.

Each kernel also has a plain PyTorch version here (`_fwd_plain`,
`_bwd_dq_plain`, `_bwd_dkv_plain`):
a tiled online softmax with the kernels' exact empty-row contract. It is the
only path for tensors on the CPU, and the reference the kernels are held to
on the card. For a CUDA tensor a wrapper launches its kernel or raises; it
never falls back to the plain version.

Layouts: the internal passes run on [b, h, s, hd] with lse / delta rows
[b, h, s, 1] fp32 and segment ids [b, s] int32 (0 = pad), like the
reference's `_fwd` / `_bwd`, which ring attention calls directly; the public
`flash_attention` keeps the [b, s, h, hd] signature of the exact op.

`launch_counts` counts kernel launches per pass ("fwd", "dq", "dkv") over the
process: a run can show that its attention went through the kernels.

Each pass has two routes, chosen by `fwd_route`, `dq_route` and
`dkv_route` from the dtype and head_dim alone before any launch: bf16 runs
on the tensor cores (`fwd_tc_kernel`, `bwd_dq_tc_kernel`,
`bwd_dkv_tc_kernel`: wgmma fed by TMA), fp32 on the SIMT kernels (wgmma on
fp32 would be TF32). The tensor-core route refuses operands that are not
16-byte aligned; it never falls back. `tensor_core_counts` counts the calls
of each pass that took the tensor cores, `segmented_counts` those that
carried segment ids; `reset_launch_counts` zeroes the three dicts.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Any

import torch

from llama_pipeline_parallel_tpu_torch.ops.fused_ce import SIMT, TENSOR_CORE

NEG_INF = -1e30
_PLAIN_BLOCK = 64  # kv tile of the plain version (the SIMT kernels' tile)
KERNEL_HEAD_DIMS = (128,)  # head_dim instantiations: every LLaMA preset's
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"fwd": 0, "dq": 0, "dkv": 0}
tensor_core_counts = {"fwd": 0, "dq": 0, "dkv": 0}
segmented_counts = {"fwd": 0, "dq": 0, "dkv": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, tensor_core_counts, segmented_counts):
        for key in counts:
            counts[key] = 0


def _route(dtype: torch.dtype, hd: int) -> str:
    if dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash attention kernels take float32 or bfloat16, got {dtype}")
    if hd not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in {KERNEL_HEAD_DIMS}, got {hd}")
    return TENSOR_CORE if dtype == torch.bfloat16 else SIMT


def fwd_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes a forward: TENSOR_CORE for bf16, SIMT for fp32;
    any other dtype or head_dim is refused. Every sequence length, offset,
    GQA group and segment layout takes the dtype's route (TMA zero-fills
    ragged tiles; the masks run in registers)."""
    return _route(dtype, hd)


def dq_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes a dq: as `fwd_route`."""
    return _route(dtype, hd)


def dkv_route(dtype: torch.dtype, hd: int) -> str:
    """The kernel that takes a dk/dv: as `fwd_route`."""
    return _route(dtype, hd)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and on-card reference)
# ---------------------------------------------------------------------------

def _tile_visible(sq: int, k0: int, k1: int, causal: bool, q_offset: int,
                  kv_offset: int, segments_q, segments_kv, device) -> torch.Tensor | None:
    """[b or 1, 1, sq, k1 - k0] bool: the scores of kv columns [k0, k1) that
    survive the causal and segment masks (None = all of them)."""
    ok = None
    if causal:
        qpos = q_offset + torch.arange(sq, device=device)
        kpos = kv_offset + torch.arange(k0, k1, device=device)
        ok = (qpos[:, None] >= kpos[None, :])[None, None]
    if segments_q is not None:
        seg_k = segments_kv[:, k0:k1]
        seg = ((segments_q[:, :, None] == seg_k[:, None, :])
               & (seg_k[:, None, :] != 0))[:, None]
        ok = seg if ok is None else ok & seg
    return ok


def _fwd_plain(q, k, v, *, causal, scale, q_offset=0, kv_offset=0,
               segments_q=None, segments_kv=None):
    b, h, sq, hd = q.shape
    group = h // k.shape[1]
    skv = k.shape[2]
    qf = q.float() * scale
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    m = torch.full((b, h, sq, 1), NEG_INF, device=q.device)
    l = torch.zeros((b, h, sq, 1), device=q.device)
    acc = torch.zeros((b, h, sq, hd), device=q.device)
    for k0 in range(0, skv, _PLAIN_BLOCK):
        k1 = min(k0 + _PLAIN_BLOCK, skv)
        s = qf @ kf[:, :, k0:k1].transpose(-1, -2)
        ok = _tile_visible(sq, k0, k1, causal, q_offset, kv_offset, segments_q,
                           segments_kv, q.device)
        if ok is not None:
            s = torch.where(ok, s, NEG_INF)
        m_cur = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        correction = torch.exp(m - m_cur)
        # masked entries contribute zero even when the whole row is masked
        p = torch.where(s > NEG_INF / 2, torch.exp(s - m_cur), 0.0)
        l = correction * l + p.sum(dim=-1, keepdim=True)
        acc = acc * correction + p @ vf[:, :, k0:k1]
        m = m_cur
    safe_l = torch.where(l > 0, l, 1.0)
    out = torch.where(l > 0, acc / safe_l, 0.0).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(safe_l), NEG_INF)
    return out, lse


def _bwd_tiles(q, k_full, v_full, delta, lse, do, *, causal, scale, q_offset,
               kv_offset, segments_q, segments_kv):
    """Per kv tile [k0, k1): (k0, k1, q * scale, K tile, dO, P, dS) in fp32,
    P recomputed from the saved lse (p = 0 on rows with lse = NEG_INF)."""
    sq, skv = q.shape[2], k_full.shape[2]
    qf = q.float() * scale
    kf, vf, dof = k_full.float(), v_full.float(), do.float()
    live = lse > NEG_INF / 2
    for k0 in range(0, skv, _PLAIN_BLOCK):
        k1 = min(k0 + _PLAIN_BLOCK, skv)
        kb = kf[:, :, k0:k1]
        s = qf @ kb.transpose(-1, -2)
        ok = _tile_visible(sq, k0, k1, causal, q_offset, kv_offset, segments_q,
                           segments_kv, q.device)
        if ok is not None:
            s = torch.where(ok, s, NEG_INF)
        p = torch.where(live, torch.exp(s - lse), 0.0)
        ds = p * (dof @ vf[:, :, k0:k1].transpose(-1, -2) - delta)
        yield k0, k1, qf, kb, dof, p, ds


def _bwd_dq_plain(q, k_full, v_full, delta, lse, do, *, scale, **kw):
    dq = torch.zeros(q.shape, device=q.device)
    for _, _, _, kb, _, _, ds in _bwd_tiles(q, k_full, v_full, delta, lse, do,
                                            scale=scale, **kw):
        dq += scale * (ds @ kb)
    return dq.to(q.dtype)


def _bwd_dkv_plain(q, k_full, v_full, delta, lse, do, **kw):
    dk = torch.empty(k_full.shape, device=q.device)
    dv = torch.empty(v_full.shape, device=q.device)
    for k0, k1, qf, _, dof, p, ds in _bwd_tiles(q, k_full, v_full, delta, lse, do, **kw):
        # q is pre-scaled, so ds^T q already carries the 1 / sqrt(hd)
        dk[:, :, k0:k1] = ds.transpose(-1, -2) @ qf
        dv[:, :, k0:k1] = p.transpose(-1, -2) @ dof
    return dk.to(k_full.dtype), dv.to(v_full.dtype)


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built at first use), with its C signatures."""
    from llama_pipeline_parallel_tpu_torch.ops import kernel_build

    lib = kernel_build.load("flash_attention")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.lpt_flash_fwd.argtypes = [p] * 7 + [i] * 7 + [f] + [i] * 3 + [p]
    lib.lpt_flash_bwd_dq.argtypes = [p] * 9 + [i] * 6 + [f] + [i] * 3 + [p]
    lib.lpt_flash_bwd_dkv.argtypes = [p] * 10 + [i] * 6 + [f] + [i] * 3 + [p]
    lib.lpt_flash_fwd_tc.argtypes = [p] * 7 + [i] * 5 + [f] + [i] * 3 + [p]
    lib.lpt_flash_bwd_dq_tc.argtypes = [p] * 9 + [i] * 4 + [f] + [i] * 3 + [p]
    lib.lpt_flash_bwd_dkv_tc.argtypes = [p] * 10 + [i] * 4 + [f] + [i] * 3 + [p]
    for fn in (lib.lpt_flash_fwd, lib.lpt_flash_bwd_dq, lib.lpt_flash_bwd_dkv,
               lib.lpt_flash_fwd_tc, lib.lpt_flash_bwd_dq_tc, lib.lpt_flash_bwd_dkv_tc):
        fn.restype = ctypes.c_int
    lib.lpt_error_string.argtypes = [ctypes.c_int]
    lib.lpt_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().lpt_error_string(err).decode()
        raise RuntimeError(f"flash attention {what} kernel launch failed: {msg} ({err})")


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shape: tuple) -> None:
    if t.device != like.device:
        raise ValueError(f"{name} is on {t.device}, q on {like.device}")
    if t.dtype != like.dtype:
        raise ValueError(f"{name} dtype {t.dtype} differs from q's {like.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor, shape: tuple,
                dtype: torch.dtype) -> None:
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != tuple(shape) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape "
                         f"{tuple(shape)} on {like.device}; got {t.dtype} "
                         f"{tuple(t.shape)} on {t.device}")


def _check_kernel_input(q: torch.Tensor) -> None:
    if q.device.type != "cuda":
        raise ValueError(f"flash attention runs on cuda or cpu tensors, got {q.device}")
    if q.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"flash attention kernels take float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4:
        raise ValueError(f"flash attention kernels take [b, h, s, hd] tensors, got {tuple(q.shape)}")
    if q.shape[-1] not in KERNEL_HEAD_DIMS:
        raise ValueError(f"flash attention kernels take head_dim in "
                         f"{KERNEL_HEAD_DIMS}, got {q.shape[-1]}")


def _check_aligned(tensors, what: str) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the tensor-core flash {what} reads its operands by TMA, which "
                         f"needs 16-byte aligned tensors")


def _seg_ptrs(segments_q, segments_kv, q, b, sq, skv):
    if segments_q is None:
        return None, None
    _check_rows("segments_q", segments_q, q, (b, sq), torch.int32)
    _check_rows("segments_kv", segments_kv, q, (b, skv), torch.int32)
    return segments_q.data_ptr(), segments_kv.data_ptr()


def _fwd_cuda(q, k, v, *, causal, scale, q_offset, kv_offset, segments_q,
              segments_kv):
    _check_kernel_input(q)
    b, h, sq, hd = q.shape
    h_kv, skv = k.shape[1], k.shape[2]
    if h % h_kv:
        raise ValueError(f"q heads {h} not a multiple of kv heads {h_kv}")
    _check("q", q, q, (b, h, sq, hd))
    _check("k", k, q, (b, h_kv, skv, hd))
    _check("v", v, q, (b, h_kv, skv, hd))
    seg_q, seg_kv = _seg_ptrs(segments_q, segments_kv, q, b, sq, skv)
    tensor_cores = fwd_route(q.dtype, hd) == TENSOR_CORE
    if tensor_cores:
        _check_aligned((q, k, v), "forward")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq, 1), dtype=torch.float32, device=q.device)
    ins = (q.data_ptr(), k.data_ptr(), v.data_ptr(), seg_q, seg_kv, out.data_ptr(),
           lse.data_ptr(), b, h, h_kv, sq, skv)
    masks = (scale, int(causal), int(q_offset), int(kv_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            err = _lib().lpt_flash_fwd_tc(*ins, *masks, stream)
        else:
            err = _lib().lpt_flash_fwd(*ins, hd, _KERNEL_DTYPES[q.dtype], *masks, stream)
    _check_launch(err, "forward")
    launch_counts["fwd"] += 1
    tensor_core_counts["fwd"] += int(tensor_cores)
    segmented_counts["fwd"] += int(segments_q is not None)
    return out, lse


def _check_bwd_inputs(q, k_full, v_full, delta, lse, do, segments_q, segments_kv):
    _check_kernel_input(q)
    b, h, sq, hd = q.shape
    skv = k_full.shape[2]
    _check("q", q, q, (b, h, sq, hd))
    _check("k_full", k_full, q, (b, h, skv, hd))
    _check("v_full", v_full, q, (b, h, skv, hd))
    _check("do", do, q, (b, h, sq, hd))
    _check_rows("lse", lse, q, (b, h, sq, 1), torch.float32)
    _check_rows("delta", delta, q, (b, h, sq, 1), torch.float32)
    seg_q, seg_kv = _seg_ptrs(segments_q, segments_kv, q, b, sq, skv)
    ins = (q.data_ptr(), k_full.data_ptr(), v_full.data_ptr(), do.data_ptr(),
           lse.data_ptr(), delta.data_ptr(), seg_q, seg_kv)
    return ins, (b, h, sq, skv, hd, _KERNEL_DTYPES[q.dtype])


def _bwd_dq_cuda(q, k_full, v_full, delta, lse, do, *, causal, scale, q_offset,
                 kv_offset, segments_q, segments_kv):
    ins, dims = _check_bwd_inputs(q, k_full, v_full, delta, lse, do, segments_q,
                                  segments_kv)
    tensor_cores = dq_route(q.dtype, q.shape[-1]) == TENSOR_CORE
    if tensor_cores:
        _check_aligned((q, k_full, v_full, do), "dq")
    dq = torch.empty_like(q)
    masks = (scale, int(causal), int(q_offset), int(kv_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            err = _lib().lpt_flash_bwd_dq_tc(*ins, dq.data_ptr(), *dims[:4], *masks, stream)
        else:
            err = _lib().lpt_flash_bwd_dq(*ins, dq.data_ptr(), *dims, *masks, stream)
    _check_launch(err, "dq")
    launch_counts["dq"] += 1
    tensor_core_counts["dq"] += int(tensor_cores)
    segmented_counts["dq"] += int(segments_q is not None)
    return dq


def _bwd_dkv_cuda(q, k_full, v_full, delta, lse, do, *, causal, scale, q_offset,
                  kv_offset, segments_q, segments_kv):
    ins, dims = _check_bwd_inputs(q, k_full, v_full, delta, lse, do, segments_q,
                                  segments_kv)
    tensor_cores = dkv_route(q.dtype, q.shape[-1]) == TENSOR_CORE
    if tensor_cores:
        _check_aligned((q, k_full, v_full, do), "dk/dv")
    dk = torch.empty_like(k_full)
    dv = torch.empty_like(v_full)
    masks = (scale, int(causal), int(q_offset), int(kv_offset))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            err = _lib().lpt_flash_bwd_dkv_tc(*ins, dk.data_ptr(), dv.data_ptr(), *dims[:4],
                                              *masks, stream)
        else:
            err = _lib().lpt_flash_bwd_dkv(*ins, dk.data_ptr(), dv.data_ptr(), *dims, *masks,
                                           stream)
    _check_launch(err, "dk/dv")
    launch_counts["dkv"] += 1
    tensor_core_counts["dkv"] += int(tensor_cores)
    segmented_counts["dkv"] += int(segments_q is not None)
    return dk, dv


# ---------------------------------------------------------------------------
# The internal entries (the reference's `_fwd` / `_bwd`)
# ---------------------------------------------------------------------------

def _fwd(q, k, v, *, causal, scale, q_offset=0, kv_offset=0, segments_q=None,
         segments_kv=None):
    """q: [b, h, sq, hd]; k/v: [b, h_kv, skv, hd] -> out [b, h, sq, hd] (q's
    dtype), lse [b, h, sq, 1] fp32. `segments_q` / `segments_kv`: [b, s] int32
    segment ids (0 = pad) of the q rows and kv columns — the same tensor for
    self-attention."""
    if (segments_q is None) != (segments_kv is None):
        raise ValueError("segments_q and segments_kv must be given together")
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_offset=kv_offset,
              segments_q=segments_q, segments_kv=segments_kv)
    if q.device.type == "cpu":
        return _fwd_plain(q, k, v, **kw)
    return _fwd_cuda(q, k, v, **kw)


def _bwd(q, k_full, v_full, delta, lse, do, *, causal, scale, q_offset=0,
         kv_offset=0, segments_q=None, segments_kv=None):
    """All of q, k_full, v_full, do: [b, h, s, hd] (kv expanded to the q
    heads); delta = rowsum(dO * O) and lse: [b, h, sq, 1] fp32, given by the
    caller. Returns (dq, dk_full, dv_full) in the inputs' dtypes."""
    if (segments_q is None) != (segments_kv is None):
        raise ValueError("segments_q and segments_kv must be given together")
    kw = dict(causal=causal, scale=scale, q_offset=q_offset, kv_offset=kv_offset,
              segments_q=segments_q, segments_kv=segments_kv)
    if q.device.type == "cpu":
        dq_fn, dkv_fn = _bwd_dq_plain, _bwd_dkv_plain
    else:
        dq_fn, dkv_fn = _bwd_dq_cuda, _bwd_dkv_cuda
    dq = dq_fn(q, k_full, v_full, delta, lse, do, **kw)
    return (dq, *dkv_fn(q, k_full, v_full, delta, lse, do, **kw))


class _FlashAttention(torch.autograd.Function):
    """Forward is the forward kernel; backward the dq and dk/dv kernels."""

    @staticmethod
    def forward(ctx, q, k, v, segments, causal, scale, q_offset, kv_offset):
        out, lse = _fwd(q, k, v, causal=causal, scale=scale, q_offset=q_offset,
                        kv_offset=kv_offset, segments_q=segments,
                        segments_kv=segments)
        ctx.save_for_backward(q, k, v, segments, out, lse)
        ctx.args = (causal, scale, q_offset, kv_offset)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, segments, out, lse = ctx.saved_tensors
        causal, scale, q_offset, kv_offset = ctx.args
        h, h_kv = q.shape[1], k.shape[1]
        group = h // h_kv
        # the backward materialises grouped KV at full heads (the forward never
        # does); the group sum of dk/dv happens outside the kernels
        k_full = k.repeat_interleave(group, dim=1) if group > 1 else k
        v_full = v.repeat_interleave(group, dim=1) if group > 1 else v
        do = do.contiguous()
        delta = (do.float() * out.float()).sum(dim=-1, keepdim=True)
        dq, dk_full, dv_full = _bwd(
            q, k_full, v_full, delta, lse, do, causal=causal, scale=scale,
            q_offset=q_offset, kv_offset=kv_offset, segments_q=segments,
            segments_kv=segments)
        if group > 1:
            b, _, skv, hd = dk_full.shape
            dk = dk_full.view(b, h_kv, group, skv, hd).sum(dim=2).to(k.dtype)
            dv = dv_full.view(b, h_kv, group, skv, hd).sum(dim=2).to(v.dtype)
        else:
            dk, dv = dk_full, dv_full
        return dq, dk, dv, None, None, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    padding_mask: Any = None,
    *,
    causal: bool = True,
    q_offset: int = 0,
    kv_offset: int = 0,
) -> torch.Tensor:
    """Drop-in AttnFn (same [b, s, h, hd] signature as ops.attention.attention).

    padding_mask semantics match the exact op: it carries SEGMENT IDS (0 =
    pad, packed examples numbered 1..k). In self-attention (sq == skv) a given
    mask turns on the in-kernel cross-segment test; with right-padded causal
    0/1 masks that test is a no-op, so passing or omitting the mask is
    equivalent there.
    """
    if q.shape[2] % k.shape[2]:
        raise ValueError(f"q heads {q.shape[2]} not a multiple of kv heads {k.shape[2]}")
    scale = q.shape[-1] ** -0.5
    segments = None
    if padding_mask is not None and q.shape[1] == k.shape[1]:
        segments = torch.as_tensor(padding_mask, device=q.device).to(torch.int32).contiguous()
    # kernels run on [b, h, s, hd]
    qt = q.transpose(1, 2).contiguous()
    kt = k.transpose(1, 2).contiguous()
    vt = v.transpose(1, 2).contiguous()
    out = _FlashAttention.apply(qt, kt, vt, segments, causal, scale, q_offset, kv_offset)
    return out.transpose(1, 2)
