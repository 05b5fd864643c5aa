"""Fused lm-head + cross-entropy with a hand-written CUDA kernel for each
pass, as a `torch.autograd.Function`.

The counterpart of llama_pipeline_parallel_tpu/ops/pallas_ce.py. Its three
Pallas TPU kernels become the kernels of `csrc/fused_ce.cu` (see that file for
the design and what bounds it): the forward statistics (lse and the target
logit per token), dh and dW. The [tokens, V] logits never reach device
memory; the backward recomputes them one vocab chunk at a time, writes that
chunk's gradient g = (softmax - onehot) * valid * ct in the compute dtype to
an [n, V / num_chunks] scratch, and forms dh and dW from it.

Each kernel also has a plain PyTorch version here (`_fwd_stats_plain`,
`_dh_plain`, `_dw_plain`): the TPU kernels' vocab-chunk schedule in fp32
math, with g cast to the compute dtype before the products as `_tile_grad`
does. It is the only path for tensors on the CPU, and the reference the
kernels are held to on the card. For a CUDA tensor a wrapper launches its
kernel or raises; it never falls back to the plain version.

`launch_counts` counts calls of each TPU kernel's counterpart ("ce_fwd",
"ce_dh", "ce_dw") over the process, one per call however many CUDA launches
it takes: a run can show that its loss head went through the kernels.

The forward and the backward each have two routes, chosen by
`forward_route` and `backward_route` from the dtype and shape alone before
any launch: bf16 with a width and a vocab (forward) or chunk width
(backward) that are multiples of 8 (what TMA can address) runs on the
tensor-core kernels, the rest (fp32 above all: wgmma on fp32 would be TF32)
on the SIMT kernels. `tensor_core_counts` counts the calls of "ce_fwd",
"ce_dh" and "ce_dw" that took the tensor cores; `reset_launch_counts`
zeroes both dicts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama_pipeline_parallel_tpu_torch.ops.cross_entropy import IGNORE_INDEX

_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}
tensor_core_counts = {"ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}

TENSOR_CORE, SIMT = "tensor_core", "simt"


def reset_launch_counts() -> None:
    for counts in (launch_counts, tensor_core_counts):
        for key in counts:
            counts[key] = 0


def _route(dtype: torch.dtype, *widths: int) -> str:
    if dtype == torch.bfloat16 and all(w % 8 == 0 for w in widths):
        return TENSOR_CORE
    return SIMT


def forward_route(dtype: torch.dtype, d: int, v: int) -> str:
    """The kernels that take a forward of width d over a vocab of v:
    TENSOR_CORE for bf16 when d and v are multiples of 8 (TMA's 16-byte row
    strides of h and W), else SIMT."""
    return _route(dtype, d, v)


def backward_route(dtype: torch.dtype, d: int, vc: int) -> str:
    """The kernels that take a backward of width d and chunk width vc:
    TENSOR_CORE for bf16 when d and vc are multiples of 8 (TMA's 16-byte row
    strides, and W + c0 on a 16-byte boundary), else SIMT."""
    return _route(dtype, d, vc)


def _chunk_width(vocab: int, num_chunks: int) -> int:
    if num_chunks < 1 or vocab % num_chunks:
        raise ValueError(f"vocab {vocab} not divisible by num_chunks={num_chunks}")
    return vocab // num_chunks


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and on-card reference)
# ---------------------------------------------------------------------------

def _fwd_stats_plain(hN, w, safe_t, num_chunks):
    """hN [n, d], w [d, V], safe_t [n] int -> (lse, tgt) [n] fp32: the online
    logsumexp over vocab chunks and the target's logit (0 where no chunk
    owns the target)."""
    vc = _chunk_width(w.shape[1], num_chunks)
    hf, wf = hN.float(), w.float()
    n = hN.shape[0]
    m = torch.full((n,), float("-inf"), device=hN.device)
    z = torch.zeros((n,), device=hN.device)
    tgt = torch.zeros((n,), device=hN.device)
    for c0 in range(0, w.shape[1], vc):
        logits = hf @ wf[:, c0:c0 + vc]
        m_new = torch.maximum(m, logits.amax(dim=-1))
        z = z * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(dim=-1)
        li = safe_t.long() - c0
        owned = (li >= 0) & (li < vc)
        picked = logits.gather(1, li.clamp(0, vc - 1)[:, None])[:, 0]
        tgt = torch.where(owned, picked, tgt)
        m = m_new
    return m + torch.log(z), tgt


def _grad_chunks(hN, w, safe_t, lse, svec, num_chunks, g_dtype):
    """Per vocab chunk: (c0, the chunk of w in fp32, g in fp32), where
    g = ((softmax - onehot) * svec) rounded to `g_dtype` (the compute dtype
    the kernels round it to before the products)."""
    vc = _chunk_width(w.shape[1], num_chunks)
    hf, wf = hN.float(), w.float()
    cols = torch.arange(vc, device=hN.device)
    for c0 in range(0, w.shape[1], vc):
        wc = wf[:, c0:c0 + vc]
        p = torch.exp(hf @ wc - lse[:, None])
        onehot = cols[None, :] == (safe_t.long() - c0)[:, None]
        g = ((p - onehot.float()) * svec[:, None]).to(g_dtype).float()
        yield c0, wc, g


def _dh_plain(hN, w, safe_t, lse, svec, num_chunks, g_dtype=None):
    """dh = sum over chunks of g W_c^T: [n, d] fp32."""
    dh = torch.zeros(hN.shape, dtype=torch.float32, device=hN.device)
    for _, wc, g in _grad_chunks(hN, w, safe_t, lse, svec, num_chunks, g_dtype or hN.dtype):
        dh += g @ wc.transpose(0, 1)
    return dh


def _dw_plain(hN, w, safe_t, lse, svec, num_chunks, g_dtype=None):
    """dW = h^T g, chunk by chunk: [d, V] fp32."""
    dw = torch.empty(w.shape, dtype=torch.float32, device=w.device)
    hT = hN.float().transpose(0, 1)
    for c0, wc, g in _grad_chunks(hN, w, safe_t, lse, svec, num_chunks, g_dtype or hN.dtype):
        dw[:, c0:c0 + wc.shape[1]] = hT @ g
    return dw


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built at first use), with its C signatures."""
    from llama_pipeline_parallel_tpu_torch.ops import kernel_build

    lib = kernel_build.load("fused_ce")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lpt_ce_fwd.argtypes = [p] * 8 + [i] * 4 + [p]
    lib.lpt_ce_fwd_tc.argtypes = [p] * 8 + [i] * 3 + [p]
    lib.lpt_ce_grad.argtypes = [p] * 6 + [i] * 6 + [p]
    lib.lpt_ce_dh.argtypes = [p] * 3 + [i] * 7 + [p]
    lib.lpt_ce_dw.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.lpt_ce_grad_tc.argtypes = [p] * 6 + [i] * 5 + [p]
    lib.lpt_ce_dh_tc.argtypes = [p] * 3 + [i] * 6 + [p]
    lib.lpt_ce_dw_tc.argtypes = [p] * 3 + [i] * 5 + [p]
    for fn in (lib.lpt_ce_fwd, lib.lpt_ce_grad, lib.lpt_ce_dh, lib.lpt_ce_dw, lib.lpt_ce_fwd_tc,
               lib.lpt_ce_grad_tc, lib.lpt_ce_dh_tc, lib.lpt_ce_dw_tc, lib.lpt_ce_vocab_tile,
               lib.lpt_ce_vocab_tile_tc):
        fn.restype = ctypes.c_int
    lib.lpt_ce_error_string.argtypes = [ctypes.c_int]
    lib.lpt_ce_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().lpt_ce_error_string(err).decode()
        raise RuntimeError(f"fused CE {what} kernel launch failed: {msg} ({err})")


def _check_rows(name: str, t: torch.Tensor, like: torch.Tensor, n: int,
                dtype: torch.dtype) -> None:
    if t.device != like.device or t.dtype != dtype or tuple(t.shape) != (n,) \
            or not t.is_contiguous():
        raise ValueError(f"{name} must be a contiguous {dtype} tensor of shape ({n},) "
                         f"on {like.device}; got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_kernel_inputs(hN, w, safe_t, num_chunks, lse=None, svec=None) -> int:
    """Raise on what the kernels do not take; return the chunk width."""
    if hN.device.type != "cuda":
        raise ValueError(f"fused CE runs on cuda or cpu tensors, got {hN.device}")
    if hN.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused CE kernels take float32 or bfloat16, got {hN.dtype}")
    if hN.dim() != 2 or w.dim() != 2 or w.shape[0] != hN.shape[1]:
        raise ValueError(f"fused CE kernels take h [n, d] and w [d, V]; got "
                         f"{tuple(hN.shape)} and {tuple(w.shape)}")
    if w.device != hN.device or w.dtype != hN.dtype:
        raise ValueError(f"w is {w.dtype} on {w.device}, h {hN.dtype} on {hN.device}")
    if not (hN.is_contiguous() and w.is_contiguous()):
        raise ValueError("h and w must be contiguous")
    n = hN.shape[0]
    _check_rows("safe_t", safe_t, hN, n, torch.int32)
    if lse is not None:
        _check_rows("lse", lse, hN, n, torch.float32)
        _check_rows("svec", svec, hN, n, torch.float32)
    return _chunk_width(w.shape[1], num_chunks)


def _check_tma_aligned(*tensors) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("the tensor-core CE kernels read h and w by TMA, which needs "
                         "16-byte aligned tensors")


def _fwd_stats_cuda(hN, w, safe_t, num_chunks):
    """The forward kernels: (lse, tgt) [n] fp32. The chunk count does not
    change what they compute (the grid tiles the whole vocab); it is checked
    like the TPU kernel's. The route (tensor cores or SIMT) is
    `forward_route`'s, fixed before the launch."""
    _check_kernel_inputs(hN, w, safe_t, num_chunks)
    (n, d), v = hN.shape, w.shape[1]
    tensor_cores = forward_route(hN.dtype, d, v) == TENSOR_CORE
    if tensor_cores:
        _check_tma_aligned(hN, w)
    lib = _lib()
    tile = lib.lpt_ce_vocab_tile_tc() if tensor_cores else lib.lpt_ce_vocab_tile()
    part = torch.empty((3, -(-v // tile), n), dtype=torch.float32, device=hN.device)
    lse = torch.empty((n,), dtype=torch.float32, device=hN.device)
    tgt = torch.empty((n,), dtype=torch.float32, device=hN.device)
    args = (hN.data_ptr(), w.data_ptr(), safe_t.data_ptr(), part[0].data_ptr(),
            part[1].data_ptr(), part[2].data_ptr(), lse.data_ptr(), tgt.data_ptr(), n, d, v)
    with torch.cuda.device(hN.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            err = lib.lpt_ce_fwd_tc(*args, stream)
        else:
            err = lib.lpt_ce_fwd(*args, _KERNEL_DTYPES[hN.dtype], stream)
    _check_launch(err, "forward")
    launch_counts["ce_fwd"] += 1
    tensor_core_counts["ce_fwd"] += int(tensor_cores)
    return lse, tgt


def _backward_cuda(hN, w, safe_t, lse, svec, num_chunks, *, want_dh=True, want_dw=True):
    """The backward kernels, chunk by chunk: (dh [n, d] fp32 or None,
    dW [d, V] in w's dtype or None). With both wanted, each chunk's g is
    recomputed once and feeds both products. The route (tensor cores or
    SIMT) is `backward_route`'s, fixed before the first launch."""
    vc = _check_kernel_inputs(hN, w, safe_t, num_chunks, lse, svec)
    (n, d), v = hN.shape, w.shape[1]
    tensor_cores = backward_route(hN.dtype, d, vc) == TENSOR_CORE
    if tensor_cores:
        _check_tma_aligned(hN, w)
    g = torch.empty((n, vc), dtype=hN.dtype, device=hN.device)
    dh = torch.empty((n, d), dtype=torch.float32, device=hN.device) if want_dh else None
    dw = torch.empty((d, v), dtype=w.dtype, device=w.device) if want_dw else None
    lib = _lib()
    if tensor_cores:
        grad, dh_fn, dw_fn = lib.lpt_ce_grad_tc, lib.lpt_ce_dh_tc, lib.lpt_ce_dw_tc
        dtype_arg = ()
    else:
        grad, dh_fn, dw_fn = lib.lpt_ce_grad, lib.lpt_ce_dh, lib.lpt_ce_dw
        dtype_arg = (_KERNEL_DTYPES[hN.dtype],)
    with torch.cuda.device(hN.device):
        stream = torch.cuda.current_stream().cuda_stream
        for c0 in range(0, v, vc):
            _check_launch(grad(hN.data_ptr(), w.data_ptr(), safe_t.data_ptr(), lse.data_ptr(),
                               svec.data_ptr(), g.data_ptr(), n, d, v, c0, vc, *dtype_arg,
                               stream), "gradient")
            if want_dh:
                _check_launch(dh_fn(g.data_ptr(), w.data_ptr(), dh.data_ptr(), n, d, v, c0, vc,
                                    int(c0 > 0), *dtype_arg, stream), "dh")
            if want_dw:
                _check_launch(dw_fn(hN.data_ptr(), g.data_ptr(), dw.data_ptr(), n, d, v, c0, vc,
                                    *dtype_arg, stream), "dW")
    for key, wanted in (("ce_dh", want_dh), ("ce_dw", want_dw)):
        launch_counts[key] += int(wanted)
        tensor_core_counts[key] += int(wanted and tensor_cores)
    return dh, dw


def _dh_cuda(hN, w, safe_t, lse, svec, num_chunks):
    return _backward_cuda(hN, w, safe_t, lse, svec, num_chunks, want_dw=False)[0]


def _dw_cuda(hN, w, safe_t, lse, svec, num_chunks):
    return _backward_cuda(hN, w, safe_t, lse, svec, num_chunks, want_dh=False)[1]


# ---------------------------------------------------------------------------
# The internal entries (the reference's `_fwd_stats` / `_backward`)
# ---------------------------------------------------------------------------

def _fwd_stats(hN, w, safe_t, num_chunks):
    if hN.device.type == "cpu":
        return _fwd_stats_plain(hN, w, safe_t, num_chunks)
    return _fwd_stats_cuda(hN, w, safe_t, num_chunks)


def _backward(hN, w, safe_t, lse, svec, num_chunks, *, want_dh=True, want_dw=True):
    """(dh [n, d] fp32, dW [d, V]) or None for a gradient not wanted."""
    if hN.device.type != "cpu":
        return _backward_cuda(hN, w, safe_t, lse, svec, num_chunks, want_dh=want_dh,
                              want_dw=want_dw)
    args = (hN, w, safe_t, lse, svec, num_chunks)
    return (_dh_plain(*args) if want_dh else None, _dw_plain(*args) if want_dw else None)


class _KernelCE(torch.autograd.Function):
    """Forward is the forward kernels; backward the dh and dW kernels."""

    @staticmethod
    def forward(ctx, h, w, targets, num_chunks):
        hN = h.reshape(-1, h.shape[-1]).contiguous()
        w = w.contiguous()
        tN = targets.reshape(-1)
        valid = tN != IGNORE_INDEX
        safe_t = torch.where(valid, tN, 0).to(torch.int32).contiguous()
        lse, tgt = _fwd_stats(hN, w, safe_t, num_chunks)
        # the reference's epilogue, outside the kernels
        loss_sum = torch.where(valid, lse - tgt, 0.0).sum()
        count = valid.sum()
        ctx.save_for_backward(hN, w, safe_t, lse, valid)
        ctx.h_shape, ctx.num_chunks = h.shape, num_chunks
        ctx.mark_non_differentiable(count)
        return loss_sum, count

    @staticmethod
    def backward(ctx, ct_loss, _ct_count):
        hN, w, safe_t, lse, valid = ctx.saved_tensors
        svec = (valid.float() * ct_loss).contiguous()
        dh, dw = _backward(hN, w, safe_t, lse, svec, ctx.num_chunks,
                           want_dh=ctx.needs_input_grad[0], want_dw=ctx.needs_input_grad[1])
        if dh is not None:
            dh = dh.to(hN.dtype).reshape(ctx.h_shape)
        if dw is not None:
            dw = dw.to(w.dtype)
        return dh, dw, None, None


def kernel_ce_sum_count(h: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                        num_chunks: int = 8) -> tuple[torch.Tensor, torch.Tensor]:
    """(loss_sum fp32, valid count) of a fused h @ w classifier, on the
    kernels: `pallas_ce_sum_count`'s semantics (`kernels.ce: pallas`).

    h: [..., d] hidden states (compute dtype, fp32 or bf16 on the card);
    w: [d, V] in h's dtype; targets: [...] int labels aligned with h
    (IGNORE_INDEX = no target). `num_chunks` (V % num_chunks == 0) is the
    backward's vocab chunk: its g scratch is [tokens, V / num_chunks].
    """
    return _KernelCE.apply(h, w, targets, num_chunks)
