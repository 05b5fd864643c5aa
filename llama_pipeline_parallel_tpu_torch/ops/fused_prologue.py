"""Fused RMSNorm -> QKV -> RoPE prologue with a hand-written CUDA kernel for
each pass, as a `torch.autograd.Function`.

The counterpart of llama_pipeline_parallel_tpu/ops/pallas_prologue.py. Its
three Pallas TPU kernels become the kernels of `csrc/fused_prologue.cu` (see
that file for the design and what bounds it): the forward (norm, the three
projections, RoPE on q and k), dhidden (un-RoPE, then the three transposed
projections summed in fp32) and dW (the normed hidden recomputed, then its
products with the un-rotated cotangents). The normed hidden is never kept
for the backward (the dW kernels recompute it). The norm backward stays
outside the kernels: the autograd of ops/rmsnorm.py on dhidden, as the
reference takes `jax.vjp` of its rms_norm.

Each kernel also has a plain PyTorch version here (`_fwd_plain`,
`_dhidden_plain`, `_dw_plain`): the TPU kernels' arithmetic in fp32 math
with the same rounding points in the inputs' dtype (normed hidden, each
projection, each RoPE and un-RoPE product and sum; dhidden summed and dW
accumulated in fp32). It is the only path for tensors on the CPU, and the
reference the kernels are held to on the card. For a CUDA tensor a wrapper
launches its kernel or raises; it never falls back to the plain version.

`launch_counts` counts calls of each TPU kernel's counterpart
("prologue_fwd", "prologue_dhidden", "prologue_dw") over the process, one
per call however many CUDA launches it takes: a run can show that its
decoder layers went through the kernels.

Each pass has two routes, chosen by `fwd_route`, `dhidden_route` and
`dw_route` from the dtype and width alone before any launch: bf16 with a
width that is a multiple of 8 runs on the tensor cores (elementwise passes
write the normed hidden and the un-rotated cotangents to call-lived bf16
scratches, then wgmma products read them by TMA), the rest (fp32 above all:
wgmma on fp32 would be TF32) on the SIMT kernels. The tensor-core route
refuses operands that are not 16-byte aligned; it never falls back.
`tensor_core_counts` counts the calls of each pass that took the tensor
cores; `reset_launch_counts` zeroes both dicts.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from llama_pipeline_parallel_tpu_torch.ops.fused_ce import SIMT, TENSOR_CORE
from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm
from llama_pipeline_parallel_tpu_torch.parallel import distributed

KERNEL_HEAD_DIMS = (128,)  # head_dim the kernels take: every LLaMA preset's
_KERNEL_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

launch_counts = {"prologue_fwd": 0, "prologue_dhidden": 0, "prologue_dw": 0}
tensor_core_counts = {"prologue_fwd": 0, "prologue_dhidden": 0, "prologue_dw": 0}


def reset_launch_counts() -> None:
    for counts in (launch_counts, tensor_core_counts):
        for key in counts:
            counts[key] = 0


def _route(dtype: torch.dtype, d: int) -> str:
    return TENSOR_CORE if dtype == torch.bfloat16 and d % 8 == 0 else SIMT


def fwd_route(dtype: torch.dtype, d: int) -> str:
    """The kernels that take a forward of width d: TENSOR_CORE for bf16 when
    d is a multiple of 8 (the norm pass's 16-byte vectors and TMA's 16-byte
    row strides of x and the normed hidden; the projection widths are whole
    heads), else SIMT."""
    return _route(dtype, d)


def dhidden_route(dtype: torch.dtype, d: int) -> str:
    """The kernels that take a dhidden of width d: TENSOR_CORE for bf16 when
    d is a multiple of 8 (the epilogue stores column pairs of the fp32 dhidden
    as one word; the projection widths are whole heads, so TMA's 16-byte row
    strides hold), else SIMT."""
    return _route(dtype, d)


def dw_route(dtype: torch.dtype, d: int) -> str:
    """The kernels that take a dW of width d: TENSOR_CORE for bf16 when d is
    a multiple of 8 (as `fwd_route`: the normed hidden is the products' A
    operand), else SIMT."""
    return _route(dtype, d)


# ---------------------------------------------------------------------------
# Plain PyTorch versions (CPU path and on-card reference)
# ---------------------------------------------------------------------------

def _rnd(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """fp32 values of `t` rounded to `dtype`."""
    return t.to(dtype).float()


def _hidden_plain(xN, norm_w, eps):
    """The normed hidden [n, d] in fp32: ops/rmsnorm.py's formula, rounded to
    x's dtype, with the kernels' row statistic: the mean of squares in fp64,
    1 / sqrt(mean + eps) rounded once to fp32, which no summation order
    changes (an fp32 mean moves by an ulp with the order, and flips a few
    bf16 hidden values against any other implementation)."""
    xd = xN.double()
    rstd = (1.0 / torch.sqrt(xd.square().mean(dim=-1, keepdim=True) + eps)).float()
    return (norm_w.float() * (xN.float() * rstd)).to(xN.dtype).float()


def _rope_plain(p, cosN, sinN, head_dim, dtype):
    """HF rotate_half RoPE on p [n, heads * hd] (fp32 values), each product
    and the sum rounded to `dtype`."""
    n, width = p.shape
    half = head_dim // 2
    p3 = p.reshape(n, -1, head_dim)
    rot = torch.cat([-p3[..., half:], p3[..., :half]], dim=-1)
    out = _rnd(p3 * cosN.float()[:, None], dtype) + _rnd(rot * sinN.float()[:, None], dtype)
    return _rnd(out, dtype).reshape(n, width)


def _unrope_plain(dy, cosN, sinN, head_dim):
    """The transpose of `_rope_plain` on a cotangent dy [n, heads * hd] in its
    dtype: rotate_half's adjoint is concat(y2, -y1). fp32 values."""
    n, width = dy.shape
    half = head_dim // 2
    y3 = dy.float().reshape(n, -1, head_dim)
    ys = _rnd(y3 * sinN.float()[:, None], dy.dtype)
    rt = torch.cat([ys[..., half:], -ys[..., :half]], dim=-1)
    return _rnd(_rnd(y3 * cosN.float()[:, None], dy.dtype) + rt, dy.dtype).reshape(n, width)


def _fwd_plain(xN, norm_w, wq, wk, wv, cosN, sinN, eps, head_dim):
    """(q [n, hq * hd], k, v [n, hkv * hd]) in x's dtype."""
    dt = xN.dtype
    hidden = _hidden_plain(xN, norm_w, eps)

    def proj(w):
        return _rnd(hidden @ w.float(), dt)

    q = _rope_plain(proj(wq), cosN, sinN, head_dim, dt)
    k = _rope_plain(proj(wk), cosN, sinN, head_dim, dt)
    return q.to(dt), k.to(dt), proj(wv).to(dt)


def _dhidden_plain(dqN, dkN, dvN, wq, wk, wv, cosN, sinN, head_dim):
    """dhidden [n, d] fp32 = unrope(dq) wq^T + unrope(dk) wk^T + dv wv^T."""
    return (_unrope_plain(dqN, cosN, sinN, head_dim) @ wq.float().T
            + _unrope_plain(dkN, cosN, sinN, head_dim) @ wk.float().T
            + dvN.float() @ wv.float().T)


def _dw_plain(xN, norm_w, dqN, dkN, dvN, cosN, sinN, eps, head_dim):
    """(dwq, dwk, dwv) fp32: the recomputed normed hidden^T times the
    un-rotated cotangents."""
    hT = _hidden_plain(xN, norm_w, eps).T
    return (hT @ _unrope_plain(dqN, cosN, sinN, head_dim),
            hT @ _unrope_plain(dkN, cosN, sinN, head_dim), hT @ dvN.float())


# ---------------------------------------------------------------------------
# CUDA kernel wrappers
# ---------------------------------------------------------------------------

@functools.cache
def _lib() -> ctypes.CDLL:
    """The kernels' library (built at first use), with its C signatures."""
    from llama_pipeline_parallel_tpu_torch.ops import kernel_build

    lib = kernel_build.load("fused_prologue")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
    lib.lpt_prologue_fwd.argtypes = [p] * 11 + [i] * 4 + [f, i, p]
    lib.lpt_prologue_fwd_tc.argtypes = [p] * 11 + [i] * 4 + [f, p]
    lib.lpt_prologue_dhidden.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.lpt_prologue_dhidden_tc.argtypes = [p] * 10 + [i] * 4 + [p]
    lib.lpt_prologue_dw.argtypes = [p] * 11 + [i] * 4 + [f, i, p]
    lib.lpt_prologue_dw_tc.argtypes = [p] * 12 + [i] * 4 + [f, p]
    for fn in (lib.lpt_prologue_fwd, lib.lpt_prologue_fwd_tc, lib.lpt_prologue_dhidden,
               lib.lpt_prologue_dhidden_tc, lib.lpt_prologue_dw, lib.lpt_prologue_dw_tc,
               lib.lpt_prologue_head_dim):
        fn.restype = ctypes.c_int
    lib.lpt_prologue_error_string.argtypes = [ctypes.c_int]
    lib.lpt_prologue_error_string.restype = ctypes.c_char_p
    return lib


def _check_launch(err: int, what: str) -> None:
    if err != 0:
        msg = _lib().lpt_prologue_error_string(err).decode()
        raise RuntimeError(f"fused prologue {what} kernel launch failed: {msg} ({err})")


def _check(name: str, t: torch.Tensor, like: torch.Tensor, shape: tuple) -> None:
    if t.device != like.device or t.dtype != like.dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}; the kernels take {like.dtype} "
                         f"on {like.device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_kernel_inputs(tensors: dict, d: int, width_q: int, width_kv: int,
                         head_dim: int) -> tuple[int, int]:
    """Raise on what the kernels do not take. `tensors` maps the names x, wq,
    wk, wv, dq, dk, dv, cos, sin to the ones a kernel reads; the first fixes
    dtype, device and the token count n. The device is checked last, so every
    other refusal shows on the CPU too. Returns (hq, hkv)."""
    first = next(iter(tensors.values()))
    if first.dtype not in _KERNEL_DTYPES:
        raise ValueError(f"fused prologue kernels take float32 or bfloat16, got {first.dtype}")
    if head_dim not in KERNEL_HEAD_DIMS:
        raise ValueError(f"fused prologue kernels take head_dim in {KERNEL_HEAD_DIMS}, "
                         f"got {head_dim}")
    if width_q % head_dim or width_kv % head_dim:
        raise ValueError(f"projection widths ({width_q}, {width_kv}) must be multiples of "
                         f"head_dim={head_dim}")
    n = first.shape[0]
    shapes = {"x": (n, d), "wq": (d, width_q), "wk": (d, width_kv), "wv": (d, width_kv),
              "dq": (n, width_q), "dk": (n, width_kv), "dv": (n, width_kv),
              "cos": (n, head_dim), "sin": (n, head_dim)}
    for name, t in tensors.items():
        _check(name, t, first, shapes[name])
    if first.device.type != "cuda":
        raise ValueError(f"fused prologue runs on cuda or cpu tensors, got {first.device}")
    return width_q // head_dim, width_kv // head_dim


def _check_aligned(tensors, what: str) -> None:
    if any(t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"the tensor-core {what} reads its operands by TMA and 16-byte "
                         f"vectors, which need 16-byte aligned tensors")


def _norm_weight(norm_w, xN) -> torch.Tensor:
    """The norm weight as the kernels take it: fp32 [d] on x's device."""
    if norm_w.device != xN.device or tuple(norm_w.shape) != (xN.shape[1],) \
            or not norm_w.is_floating_point():
        raise ValueError(f"norm_w must be a float [{xN.shape[1]}] tensor on {xN.device}; got "
                         f"{norm_w.dtype} {tuple(norm_w.shape)} on {norm_w.device}")
    return norm_w.float().contiguous()


def _fwd_cuda(xN, norm_w, wq, wk, wv, cosN, sinN, eps, head_dim):
    """The forward kernels: (q, k, v) in x's dtype. The route (tensor cores
    or SIMT) is `fwd_route`'s, fixed before the first launch; the tensor-core
    route's normed-hidden scratch is freed after the call."""
    tensors = dict(x=xN, wq=wq, wk=wk, wv=wv, cos=cosN, sin=sinN)
    hq, hkv = _check_kernel_inputs(tensors, xN.shape[-1], wq.shape[-1], wk.shape[-1], head_dim)
    n, d = xN.shape
    nw = _norm_weight(norm_w, xN)
    tensor_cores = fwd_route(xN.dtype, d) == TENSOR_CORE
    if tensor_cores:
        _check_aligned([nw, *tensors.values()], "forward")
    q = torch.empty((n, hq * head_dim), dtype=xN.dtype, device=xN.device)
    k = torch.empty((n, hkv * head_dim), dtype=xN.dtype, device=xN.device)
    v = torch.empty_like(k)
    ins = [xN.data_ptr(), nw.data_ptr()]
    rest = [wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), cosN.data_ptr(), sinN.data_ptr()]
    outs = [q.data_ptr(), k.data_ptr(), v.data_ptr()]
    with torch.cuda.device(xN.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            hidden = torch.empty((n, d), dtype=xN.dtype, device=xN.device)
            err = _lib().lpt_prologue_fwd_tc(*ins, *rest, hidden.data_ptr(), *outs, n, d, hq,
                                             hkv, eps, stream)
        else:
            rstd = torch.empty((n,), dtype=torch.float32, device=xN.device)
            err = _lib().lpt_prologue_fwd(*ins, rstd.data_ptr(), *rest, *outs, n, d, hq, hkv, eps,
                                          _KERNEL_DTYPES[xN.dtype], stream)
    _check_launch(err, "forward")
    launch_counts["prologue_fwd"] += 1
    tensor_core_counts["prologue_fwd"] += int(tensor_cores)
    return q, k, v


def _dhidden_cuda(dqN, dkN, dvN, wq, wk, wv, cosN, sinN, head_dim):
    """The dhidden kernels: [n, d] fp32. The route (tensor cores or SIMT)
    is `dhidden_route`'s, fixed before the first launch; the tensor-core
    route's un-rotated scratch is freed after the call."""
    tensors = dict(dq=dqN, dk=dkN, dv=dvN, wq=wq, wk=wk, wv=wv, cos=cosN, sin=sinN)
    hq, hkv = _check_kernel_inputs(tensors, wq.shape[0], dqN.shape[-1], dkN.shape[-1], head_dim)
    n, d = dqN.shape[0], wq.shape[0]
    tensor_cores = dhidden_route(dqN.dtype, d) == TENSOR_CORE
    if tensor_cores:
        _check_aligned(tensors.values(), "dhidden")
    dh = torch.empty((n, d), dtype=torch.float32, device=dqN.device)
    ptrs = [t.data_ptr() for t in tensors.values()]
    with torch.cuda.device(dqN.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            scratch = torch.empty((n, (hq + hkv) * head_dim), dtype=dqN.dtype, device=dqN.device)
            err = _lib().lpt_prologue_dhidden_tc(*ptrs, scratch.data_ptr(), dh.data_ptr(), n, d,
                                                 hq, hkv, stream)
        else:
            err = _lib().lpt_prologue_dhidden(*ptrs, dh.data_ptr(), n, d, hq, hkv,
                                              _KERNEL_DTYPES[dqN.dtype], stream)
    _check_launch(err, "dhidden")
    launch_counts["prologue_dhidden"] += 1
    tensor_core_counts["prologue_dhidden"] += int(tensor_cores)
    return dh


def _dw_cuda(xN, norm_w, dqN, dkN, dvN, cosN, sinN, eps, head_dim):
    """The dW kernels: (dwq, dwk, dwv) in x's dtype. The route (tensor cores
    or SIMT) is `dw_route`'s, fixed before the first launch; the tensor-core
    route's scratches (the normed hidden, the un-rotated cotangents) are
    freed after the call."""
    tensors = dict(x=xN, dq=dqN, dk=dkN, dv=dvN, cos=cosN, sin=sinN)
    hq, hkv = _check_kernel_inputs(tensors, xN.shape[-1], dqN.shape[-1], dkN.shape[-1], head_dim)
    n, d = xN.shape
    nw = _norm_weight(norm_w, xN)
    tensor_cores = dw_route(xN.dtype, d) == TENSOR_CORE
    if tensor_cores:
        _check_aligned([nw, *tensors.values()], "dW")
    dwq = torch.empty((d, hq * head_dim), dtype=xN.dtype, device=xN.device)
    dwk = torch.empty((d, hkv * head_dim), dtype=xN.dtype, device=xN.device)
    dwv = torch.empty_like(dwk)
    ins = [xN.data_ptr(), nw.data_ptr()]
    rest = [dqN.data_ptr(), dkN.data_ptr(), dvN.data_ptr(), cosN.data_ptr(), sinN.data_ptr()]
    outs = [dwq.data_ptr(), dwk.data_ptr(), dwv.data_ptr()]
    with torch.cuda.device(xN.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tensor_cores:
            hidden = torch.empty((n, d), dtype=xN.dtype, device=xN.device)
            scratch = torch.empty((n, (hq + hkv) * head_dim), dtype=xN.dtype, device=xN.device)
            err = _lib().lpt_prologue_dw_tc(*ins, *rest, hidden.data_ptr(), scratch.data_ptr(),
                                            *outs, n, d, hq, hkv, eps, stream)
        else:
            rstd = torch.empty((n,), dtype=torch.float32, device=xN.device)
            err = _lib().lpt_prologue_dw(*ins, rstd.data_ptr(), *rest, *outs, n, d, hq, hkv, eps,
                                         _KERNEL_DTYPES[xN.dtype], stream)
    _check_launch(err, "dW")
    launch_counts["prologue_dw"] += 1
    tensor_core_counts["prologue_dw"] += int(tensor_cores)
    return dwq, dwk, dwv


# ---------------------------------------------------------------------------
# The internal entries (the reference's `_fwd` / `_bwd` kernels)
# ---------------------------------------------------------------------------

def _fwd(xN, norm_w, wq, wk, wv, cosN, sinN, eps, head_dim):
    fn = _fwd_plain if xN.device.type == "cpu" else _fwd_cuda
    return fn(xN, norm_w, wq, wk, wv, cosN, sinN, eps, head_dim)


def _dhidden(dqN, dkN, dvN, wq, wk, wv, cosN, sinN, head_dim):
    fn = _dhidden_plain if dqN.device.type == "cpu" else _dhidden_cuda
    return fn(dqN, dkN, dvN, wq, wk, wv, cosN, sinN, head_dim)


def _dw(xN, norm_w, dqN, dkN, dvN, cosN, sinN, eps, head_dim):
    fn = _dw_plain if xN.device.type == "cpu" else _dw_cuda
    return fn(xN, norm_w, dqN, dkN, dvN, cosN, sinN, eps, head_dim)


class _KernelPrologue(torch.autograd.Function):
    """Forward is the forward kernels; backward the dhidden kernel (then the
    norm backward) where x or the norm weight needs a gradient, and the dW
    kernel where a projection weight does. cos and sin get none."""

    @staticmethod
    def forward(ctx, xN, norm_w, wq, wk, wv, cosN, sinN, eps, head_dim, tp_group=None):
        xN, wq, wk, wv, cosN, sinN = (t.contiguous() for t in (xN, wq, wk, wv, cosN, sinN))
        q, k, v = _fwd(xN, norm_w, wq, wk, wv, cosN, sinN, eps, head_dim)
        ctx.save_for_backward(xN, norm_w, wq, wk, wv, cosN, sinN)
        ctx.eps, ctx.head_dim, ctx.tp_group = eps, head_dim, tp_group
        return q, k, v

    @staticmethod
    def backward(ctx, dq, dk, dv):
        xN, norm_w, wq, wk, wv, cosN, sinN = ctx.saved_tensors
        eps, hd, need = ctx.eps, ctx.head_dim, ctx.needs_input_grad
        dqN, dkN, dvN = (g.to(xN.dtype).contiguous() for g in (dq, dk, dv))
        dx = dnw = None
        if need[0] or need[1]:
            # the local columns' dhidden in the compute dtype, summed over the
            # tp ranks before the norm backward (the reference's cast, then psum)
            dh = distributed.all_reduce(
                _dhidden(dqN, dkN, dvN, wq, wk, wv, cosN, sinN, hd).to(xN.dtype), ctx.tp_group)
            # the norm backward: the autograd of ops/rmsnorm.py itself
            with torch.enable_grad():
                xx = xN.detach().requires_grad_(need[0])
                ww = norm_w.detach().requires_grad_(need[1])
                wanted = [t for t in (xx, ww) if t.requires_grad]
                grads = iter(torch.autograd.grad(rms_norm(xx, ww, eps), wanted, dh))
            dx = next(grads) if need[0] else None
            dnw = next(grads) if need[1] else None
        dws = [None] * 3
        if any(need[2:5]):
            dws = [g.to(w.dtype) if want else None for g, w, want in
                   zip(_dw(xN, norm_w, dqN, dkN, dvN, cosN, sinN, eps, hd), (wq, wk, wv),
                       need[2:5])]
        return (dx, dnw, *dws, None, None, None, None, None)


def fused_prologue(x: torch.Tensor, norm_w: torch.Tensor, wq: torch.Tensor, wk: torch.Tensor,
                   wv: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, *, eps: float,
                   head_dim: int, tp_group=None) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Fused rms_norm(x) -> (q|k|v) projection -> RoPE(q, k), on the kernels:
    `pallas_prologue.fused_prologue`'s semantics (`kernels.prologue: pallas`).

    x: [b, s, d] in the compute dtype (fp32 or bf16 on the card); norm_w: [d]
    (the fp32 master); wq: [d, h * hd]; wk, wv: [d, kv * hd], in x's dtype;
    cos, sin: [b, s, hd] in x's dtype. Returns q [b, s, h, hd], k and v
    [b, s, kv, hd] with RoPE applied to q and k. Under tensor parallelism
    the weights are this tp rank's columns and `tp_group` its group: the
    backward sums the hidden states' gradient over it between the dhidden
    kernel and the norm backward (the reference's tp_axis psum); the kernels
    run at the local widths.
    """
    b, s, d = x.shape
    if wq.shape[1] % head_dim or wk.shape[1] % head_dim:
        raise ValueError(f"projection widths ({wq.shape[1]}, {wk.shape[1]}) must be "
                         f"multiples of head_dim={head_dim}")
    if head_dim % 2:
        raise ValueError(f"head_dim must be even for rotate_half, got {head_dim}")
    if wk.shape != wv.shape:
        raise ValueError(f"wk {tuple(wk.shape)} and wv {tuple(wv.shape)} must match")
    n = b * s
    q, k, v = _KernelPrologue.apply(x.reshape(n, d), norm_w, wq, wk, wv,
                                    cos.reshape(n, head_dim), sin.reshape(n, head_dim), eps,
                                    head_dim, tp_group)
    return (q.view(b, s, -1, head_dim), k.view(b, s, -1, head_dim),
            v.view(b, s, -1, head_dim))
