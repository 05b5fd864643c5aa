"""The port's fused prologue (ops/fused_prologue.py) against the JAX package's
Pallas prologue kernels (ops/pallas_prologue.py, run in interpret mode on the
CPU), on the same numpy inputs: the forward's plain version against `_fwd`,
the port's backward (plain dhidden, the norm backward, plain dW) against
`_bwd`, and the public op's outputs and gradients against `jax.vjp` of the
reference's `fused_prologue`. On a card, each CUDA kernel against its plain
version.

Tolerances. fp32: the reference's own pins (tests/test_pallas_prologue.py):
forward atol 1e-5 (rtol 1e-6), gradients rtol 1e-5 with atol 2e-5; the
products are 48 deep, summed in another order, and the row statistic is taken
in fp64 here, in fp32 there (~1e-7 relative). bf16: the inputs are the same
bf16 values and both sides round at the same points, but XLA may keep excess
precision inside a fused bf16 chain (the RoPE products and sum) and sums in
another order before each rounding, so an element may land one bf16 step
away: rtol 2^-7 plus an atol of 2^-7 x the output's rms for elements near
zero.
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch.ops import fused_prologue as fp
from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm

B, S, D, HD = 2, 24, 48, 16
EPS = 1e-6
HEADS = {"mha": (4, 4), "gqa": (4, 2), "mqa": (8, 1)}
FP32_FWD = dict(rtol=1e-6, atol=1e-5)
FP32_GRAD = dict(rtol=1e-5, atol=2e-5)
BF16_STEP = 2.0 ** -7


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


# Installed as this module is collected, not only in the `ref` fixture: every
# pytest worker collects every test module before it runs a test, so each
# worker then has it before its first test, and whether a test that imports
# the reference package can do so no longer depends on which file the worker
# happened to run first.
_install_transfer_stand_in()


@pytest.fixture(scope="session")
def ref():
    """The reference's Pallas prologue module (after the stand-in above)."""
    _install_transfer_stand_in()
    return types.SimpleNamespace(
        pp=importlib.import_module("llama_pipeline_parallel_tpu.ops.pallas_prologue"))


def _inputs(heads, seed=0, pos0=3):
    """numpy fp32: x [B, S, D], the norm weight 1 + 0.1 randn, wq / wk / wv,
    cos / sin of positions pos0.. (HF rotate_half tables), and cotangents
    dq / dk / dv [B, S, heads, HD] that are not all ones."""
    h, kv = HEADS[heads]
    rng = np.random.RandomState(seed)
    f32 = np.float32
    pos = pos0 + np.arange(S, dtype=f32)
    inv = 1.0 / (10000.0 ** (np.arange(0, HD, 2, dtype=f32) / HD))
    ang = np.concatenate([pos[:, None] * inv] * 2, axis=-1)
    cos = np.broadcast_to(np.cos(ang), (B, S, HD)).astype(f32)
    sin = np.broadcast_to(np.sin(ang), (B, S, HD)).astype(f32)
    return dict(
        x=rng.randn(B, S, D).astype(f32), nw=(1 + 0.1 * rng.randn(D)).astype(f32),
        wq=(0.1 * rng.randn(D, h * HD)).astype(f32), wk=(0.1 * rng.randn(D, kv * HD)).astype(f32),
        wv=(0.1 * rng.randn(D, kv * HD)).astype(f32), cos=cos, sin=sin,
        dq=rng.randn(B, S, h, HD).astype(f32), dk=rng.randn(B, S, kv, HD).astype(f32),
        dv=rng.randn(B, S, kv, HD).astype(f32))


def _as(inp, dtype):
    """(jax arrays, torch tensors) of the inputs in `dtype`; the norm weight
    stays fp32 (the port passes the fp32 master)."""
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    j = {k: jnp.asarray(v, jnp.float32 if k == "nw" else jdt) for k, v in inp.items()}
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).to(torch.float32 if k == "nw" else tdt)
         for k, v in inp.items()}
    return j, t


def _flat(d, n=B * S):
    """The [n, *] token rows the internal entries take."""
    return {k: (v if k in ("nw", "wq", "wk", "wv") else v.reshape(n, -1)) for k, v in d.items()}


def _close(got: torch.Tensor, want, dtype: str, tol: dict, what: str) -> None:
    want = np.asarray(want, np.float32).reshape(tuple(got.shape))
    if dtype == "float32":
        np.testing.assert_allclose(got.float().numpy(), want, err_msg=what, **tol)
    else:
        atol = BF16_STEP * float(np.sqrt(np.mean(want ** 2)))
        np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP, atol=atol,
                                   err_msg=what)


DTYPES = ["float32", "bfloat16"]


# ---------------------------------------------------------------------------
# each plain version against its Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_fwd_plain_matches_pallas_kernel(ref, dtype, heads):
    j, t = (_flat(a) for a in _as(_inputs(heads), dtype))
    want = ref.pp._fwd(j["x"], j["nw"], j["wq"], j["wk"], j["wv"], j["cos"], j["sin"], EPS, HD,
                       None)
    got = fp._fwd_plain(t["x"], t["nw"], t["wq"], t["wk"], t["wv"], t["cos"], t["sin"], EPS, HD)
    for name, g, w in zip("qkv", got, want):
        assert g.dtype == getattr(torch, dtype) and tuple(g.shape) == tuple(w.shape)
        _close(g, w, dtype, FP32_FWD, name)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_backward_matches_pallas_bwd(ref, dtype, heads):
    """The port's backward -- the dhidden plain version, the norm backward on
    it, the dW plain version -- against `_bwd`'s (dx, dnorm, dwq, dwk, dwv)
    on the same cotangents."""
    j, t = (_flat(a) for a in _as(_inputs(heads, seed=1), dtype))
    want = ref.pp._bwd(j["x"], j["nw"], j["wq"], j["wk"], j["wv"], j["cos"], j["sin"], j["dq"],
                       j["dk"], j["dv"], EPS, HD, None, None)
    leaves = [t[k].clone().requires_grad_() for k in ("x", "nw", "wq", "wk", "wv")]
    outs = fp._KernelPrologue.apply(*leaves, t["cos"], t["sin"], EPS, HD)
    got = torch.autograd.grad(outs, leaves, (t["dq"], t["dk"], t["dv"]))
    for name, g, w, leaf in zip(("dx", "dnorm", "dwq", "dwk", "dwv"), got, want, leaves):
        assert g.dtype == leaf.dtype
        _close(g, w, dtype, FP32_GRAD, name)


@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_unrope_plain_matches_pallas_unrope_block(ref, dtype, heads):
    """`_unrope_plain` -- the oracle of the tensor-core route's un-rotation
    pass -- against the reference's `_unrope_block` on the same cotangents
    and cos / sin (fp32: the forward's pins; bf16: one step, as above)."""
    inp = _inputs(heads, seed=5)
    j, t = (_flat(a) for a in _as(inp, dtype))
    for name in ("dq", "dk"):
        want = ref.pp._unrope_block(j[name], j["cos"], j["sin"], HD)
        got = fp._unrope_plain(t[name], t["cos"], t["sin"], HD)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want, dtype, FP32_FWD, name)


@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 4096, fp.TENSOR_CORE),  # the slice's layers
    (torch.bfloat16, 200, fp.TENSOR_CORE),   # the ragged card case
    (torch.float32, 4096, fp.SIMT),          # wgmma on fp32 would be TF32
    (torch.float32, 200, fp.SIMT),
    (torch.bfloat16, 196, fp.SIMT),          # d % 8 != 0
    (torch.bfloat16, 4100, fp.SIMT),
])
def test_dhidden_route_by_dtype_and_shape(dtype, d, route):
    assert fp.dhidden_route(dtype, d) == route


@pytest.mark.parametrize("which", ["fwd", "dw"])
@pytest.mark.parametrize("dtype,d,route", [
    (torch.bfloat16, 4096, fp.TENSOR_CORE),  # the slice's layers
    (torch.bfloat16, 200, fp.TENSOR_CORE),   # the ragged card case
    (torch.float32, 4096, fp.SIMT),          # wgmma on fp32 would be TF32
    (torch.float32, 200, fp.SIMT),
    (torch.bfloat16, 196, fp.SIMT),          # d % 8 != 0: no 16-byte rows of the normed hidden
    (torch.bfloat16, 4100, fp.SIMT),
])
def test_fwd_and_dw_route_by_dtype_and_shape(which, dtype, d, route):
    assert getattr(fp, f"{which}_route")(dtype, d) == route


def test_reset_launch_counts_zeroes_tensor_core_counts():
    fp.launch_counts["prologue_dw"] += 2
    for key in ("prologue_fwd", "prologue_dhidden", "prologue_dw"):
        fp.tensor_core_counts[key] += 3
    fp.reset_launch_counts()
    assert fp.launch_counts == {"prologue_fwd": 0, "prologue_dhidden": 0, "prologue_dw": 0}
    assert fp.tensor_core_counts == {"prologue_fwd": 0, "prologue_dhidden": 0, "prologue_dw": 0}


@pytest.mark.parametrize("kernel", [
    "prologue_rstd_kernel", "prologue_fwd_kernel", "prologue_dhidden_kernel",
    "prologue_dw_kernel", "prologue_unrope_kernel", "prologue_dhidden_tc_kernel",
    "prologue_norm_kernel", "prologue_fwd_tc_kernel", "prologue_dw_tc_kernel"])
def test_step_profile_counts_every_prologue_kernel_in_prologue(kernel):
    """tools/torch_step_profile.py files each prologue kernel, SIMT or
    tensor-core, under the `prologue` family, by its name as the profiler
    shows it."""
    from tools import torch_step_profile

    name = f"void (anonymous namespace)::{kernel}<__nv_bfloat16>(CUtensorMap_st, int)"
    assert torch_step_profile.family(name) == "prologue"


def test_dhidden_and_dw_plain_are_the_backward_products():
    """dhidden and dW of the plain versions are the transposed products of
    the un-rotated cotangents, written out with rotate_half on q and k (fp32)."""
    _, t = _as(_inputs("gqa", seed=2), "float32")
    t = _flat(t)

    def unrope(dy):
        y = dy.reshape(dy.shape[0], -1, HD)
        c, s = t["cos"][:, None], t["sin"][:, None]
        ys = y * s
        return (y * c + torch.cat([ys[..., HD // 2:], -ys[..., :HD // 2]], -1)).reshape(dy.shape)

    dq, dk = unrope(t["dq"]), unrope(t["dk"])
    want_dh = dq @ t["wq"].T + dk @ t["wk"].T + t["dv"] @ t["wv"].T
    got_dh = fp._dhidden_plain(t["dq"], t["dk"], t["dv"], t["wq"], t["wk"], t["wv"], t["cos"],
                               t["sin"], HD)
    torch.testing.assert_close(got_dh, want_dh, rtol=1e-5, atol=1e-5)
    hidden = rms_norm(t["x"], t["nw"], EPS)
    got_dw = fp._dw_plain(t["x"], t["nw"], t["dq"], t["dk"], t["dv"], t["cos"], t["sin"], EPS, HD)
    for g, w in zip(got_dw, (hidden.T @ dq, hidden.T @ dk, hidden.T @ t["dv"])):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# the public op against the reference's fused_prologue
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("heads", sorted(HEADS))
@pytest.mark.parametrize("dtype", DTYPES)
def test_fused_prologue_matches_reference_vjp(ref, dtype, heads):
    """q, k, v and the gradients of x, the norm weight and the three weights
    under random cotangents, against jax.vjp of the reference's custom VJP."""
    j, t = _as(_inputs(heads, seed=3), dtype)
    args = ("x", "nw", "wq", "wk", "wv")

    def ref_op(*a):
        return ref.pp.fused_prologue(*a, j["cos"], j["sin"], eps=EPS, head_dim=HD)

    want, vjp = jax.vjp(ref_op, *(j[k] for k in args))
    want_grads = vjp((j["dq"], j["dk"], j["dv"]))
    leaves = [t[k].clone().requires_grad_() for k in args]
    got = fp.fused_prologue(*leaves, t["cos"], t["sin"], eps=EPS, head_dim=HD)
    for name, g, w in zip("qkv", got, want):
        assert tuple(g.shape) == tuple(w.shape)
        _close(g.detach(), w, dtype, FP32_FWD, name)
    torch.autograd.backward(got, (t["dq"], t["dk"], t["dv"]))
    for name, leaf, w in zip(args, leaves, want_grads):
        _close(leaf.grad, w, dtype, FP32_GRAD, f"d{name}")


def test_fused_prologue_matches_composed_ops():
    """On the CPU the kernel path equals the composed rms_norm -> matmul ->
    apply_rope the model runs otherwise, values and gradients (fp32)."""
    from llama_pipeline_parallel_tpu_torch.ops.rope import apply_rope

    _, t = _as(_inputs("gqa", seed=4), "float32")
    results = []
    for fused in (True, False):
        leaves = {k: t[k].clone().requires_grad_() for k in ("x", "nw", "wq", "wk", "wv")}
        if fused:
            q, k, v = fp.fused_prologue(leaves["x"], leaves["nw"], leaves["wq"], leaves["wk"],
                                        leaves["wv"], t["cos"], t["sin"], eps=EPS, head_dim=HD)
        else:
            hidden = rms_norm(leaves["x"], leaves["nw"], EPS)
            q, k, v = ((hidden @ leaves[w]).view(B, S, -1, HD) for w in ("wq", "wk", "wv"))
            q, k = apply_rope(q, k, t["cos"], t["sin"])
        torch.autograd.backward((q, k, v), (t["dq"], t["dk"], t["dv"]))
        results.append(((q, k, v), {name: leaf.grad for name, leaf in leaves.items()}))
    (fused_out, fused_grads), (comp_out, comp_grads) = results
    for a, b in zip(fused_out, comp_out):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-5)
    for name in fused_grads:
        torch.testing.assert_close(fused_grads[name], comp_grads[name], rtol=1e-5, atol=2e-5,
                                   msg=name)


def test_validation_errors():
    """The reference's three refusals, with its messages."""
    _, t = _as(_inputs("gqa"), "float32")
    x, nw, wq, wk, wv, cos, sin = (t[k] for k in ("x", "nw", "wq", "wk", "wv", "cos", "sin"))
    with pytest.raises(ValueError, match="multiples of head_dim"):
        fp.fused_prologue(x, nw, wq[:, :-1], wk, wv, cos, sin, eps=EPS, head_dim=HD)
    with pytest.raises(ValueError, match="must be even"):
        fp.fused_prologue(x, nw, wq, wk, wv, cos, sin, eps=EPS, head_dim=1)
    with pytest.raises(ValueError, match="must match"):
        fp.fused_prologue(x, nw, wq, wk, wv[:, :HD], cos, sin, eps=EPS, head_dim=HD)


def test_cos_sin_get_no_gradient():
    """cos and sin are positional data: their gradients are absent, however
    they were built."""
    _, t = _as(_inputs("mha"), "float32")
    cos, sin = t["cos"].requires_grad_(), t["sin"].requires_grad_()
    q, k, _ = fp.fused_prologue(t["x"], t["nw"], t["wq"], t["wk"], t["wv"], cos, sin, eps=EPS,
                                head_dim=HD)
    assert q.requires_grad
    (q.square().sum() + k.sum()).backward()
    assert cos.grad is None and sin.grad is None


@pytest.mark.parametrize("needs,ran", [
    (("x",), {"dhidden"}),
    (("nw",), {"dhidden"}),
    (("wq",), {"dw"}),
    (("wv", "x"), {"dhidden", "dw"}),
])
def test_backward_runs_only_the_kernels_it_needs(monkeypatch, needs, ran):
    """dhidden runs only when x or the norm weight needs a gradient, dW only
    when a weight does (zb1's B and W units differentiate one side each)."""
    _, t = _as(_inputs("gqa"), "float32")
    calls = set()
    for name in ("dhidden", "dw"):
        real = getattr(fp, f"_{name}")
        monkeypatch.setattr(fp, f"_{name}",
                            lambda *a, _n=name, _f=real: (calls.add(_n), _f(*a))[1])
    leaves = {k: t[k].requires_grad_(k in needs) for k in ("x", "nw", "wq", "wk", "wv")}
    q, k, v = fp.fused_prologue(*leaves.values(), t["cos"], t["sin"], eps=EPS, head_dim=HD)
    torch.autograd.backward((q, k, v), (t["dq"], t["dk"], t["dv"]))
    assert calls == ran
    for name, leaf in leaves.items():
        assert (leaf.grad is not None) == (name in needs), name


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers raise on a dtype, head_dim, shape or layout the
    kernels do not take, and on CPU tensors (the plain path is chosen by
    device before them, never as a fallback); nothing is built for that."""
    hd, n, d = fp.KERNEL_HEAD_DIMS[0], 4, 8
    x, nw = torch.randn(n, d), torch.ones(d)
    wq, wkv = torch.randn(d, 2 * hd), torch.randn(d, hd)
    cos = sin = torch.randn(n, hd)
    dq, dkv = torch.randn(n, 2 * hd), torch.randn(n, hd)
    fwd = (x, nw, wq, wkv, wkv, cos, sin, EPS, hd)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp._fwd_cuda(*fwd)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp._dhidden_cuda(dq, dkv, dkv, wq, wkv, wkv, cos, sin, hd)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fp._dw_cuda(x, nw, dq, dkv, dkv, cos, sin, EPS, hd)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fp._fwd_cuda(x.half(), *fwd[1:])
    with pytest.raises(ValueError, match="head_dim in"):
        fp._dw_cuda(x, nw, dq, dkv, dkv, cos[:, :64], sin[:, :64], EPS, 64)
    with pytest.raises(ValueError, match="shape"):
        fp._dhidden_cuda(dq, dkv, dkv, wq[:-1], wkv, wkv, cos, sin, hd)
    with pytest.raises(ValueError, match="bfloat16 on cpu"):
        fp._fwd_cuda(x, nw, wq.bfloat16(), wkv, wkv, cos, sin, EPS, hd)
    with pytest.raises(ValueError, match="contiguous"):
        fp._fwd_cuda(x, nw, wq.T.contiguous().T, wkv, wkv, cos, sin, EPS, hd)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,d", [
    pytest.param("float32", 200, id="float32"),
    pytest.param("bfloat16", 200, id="bfloat16"),
    pytest.param("bfloat16", 196, id="bfloat16-d196"),
])
def test_kernels_match_plain_on_card(dtype, d):
    """Each CUDA kernel against its plain version on a shape ragged to every
    tile (2 x 150 tokens, width 200 or 196, MQA 4:1, head_dim 128, positions
    from 37). The route of the forward, dhidden and dW is asserted: bf16 at
    width 200 on the tensor cores, width 196 and fp32 on the SIMT kernels.
    fp32: 1e-4 absolute (fp32 summation order). bf16: dhidden (fp32 out)
    differs by summation order only (both routes norm and un-rotate at the
    same rounding points), dW by its one rounding (2^-8 relative).
    q, k and v round at intermediate points (the projection, each RoPE
    product, the sum) from the same row statistic on both sides; where fp32
    summation order puts a projection next to a rounding midpoint, the two
    round it apart, one bf16 step of that term: at most 2^-7 of the largest
    element."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    from llama_pipeline_parallel_tpu_torch.ops.rope import rope_cos_sin

    hd, n, h, kv = fp.KERNEL_HEAD_DIMS[0], 300, 4, 1
    tdt = getattr(torch, dtype)
    rng = np.random.RandomState(7)

    def arr(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.randn(*shape)).astype(np.float32)).to("cuda", tdt)

    x, wq, wk, wv = arr(n, d), arr(d, h * hd, scale=0.05), arr(d, kv * hd, scale=0.05), \
        arr(d, kv * hd, scale=0.05)
    nw = 1 + 0.1 * torch.from_numpy(rng.randn(d).astype(np.float32)).cuda()
    pos = (37 + torch.arange(150, device="cuda")).expand(2, 150)
    cos, sin = (c.reshape(n, hd).contiguous() for c in rope_cos_sin(pos, hd, dtype=tdt))
    dq, dk, dv = arr(n, h * hd), arr(n, kv * hd), arr(n, kv * hd)
    fp.reset_launch_counts()
    got = [*fp._fwd_cuda(x, nw, wq, wk, wv, cos, sin, EPS, hd),
           fp._dhidden_cuda(dq, dk, dv, wq, wk, wv, cos, sin, hd),
           *fp._dw_cuda(x, nw, dq, dk, dv, cos, sin, EPS, hd)]
    want = [*fp._fwd_plain(x, nw, wq, wk, wv, cos, sin, EPS, hd),
            fp._dhidden_plain(dq, dk, dv, wq, wk, wv, cos, sin, hd),
            *fp._dw_plain(x, nw, dq, dk, dv, cos, sin, EPS, hd)]
    torch.cuda.synchronize()
    assert fp.launch_counts == {"prologue_fwd": 1, "prologue_dhidden": 1, "prologue_dw": 1}
    on_tensor_cores = int(dtype == "bfloat16" and d == 200)
    for route in (fp.fwd_route, fp.dhidden_route, fp.dw_route):
        assert on_tensor_cores == int(route(tdt, d) == fp.TENSOR_CORE)
    assert fp.tensor_core_counts == {key: on_tensor_cores for key in fp.launch_counts}
    for name, g, w in zip(("q", "k", "v", "dhidden", "dwq", "dwk", "dwv"), got, want):
        if dtype == "float32" or name == "dhidden":
            tol = dict(rtol=0, atol=1e-4)
        elif name.startswith("dw"):
            tol = dict(rtol=2.0 ** -8, atol=1e-4)
        else:
            tol = dict(rtol=2.0 ** -7, atol=2.0 ** -7 * w.float().abs().max().item())
        torch.testing.assert_close(g.float(), w.float(), msg=name, **tol)


@pytest.mark.cuda
def test_tensor_core_dhidden_refuses_misaligned_operands_on_card():
    """On the tensor-core route every operand of dhidden must be 16-byte
    aligned (TMA and the un-rotation's 16-byte vectors): a dq one element off
    its allocation's start is refused before any launch; nothing falls back
    to SIMT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    hd, n, d = fp.KERNEL_HEAD_DIMS[0], 16, 64

    def arr(*shape):
        return torch.randn(*shape, device="cuda").to(torch.bfloat16)

    dq = arr(n * hd + 1)[1:].view(n, hd)
    dk, dv, cos, sin = arr(n, hd), arr(n, hd), arr(n, hd), arr(n, hd)
    w = arr(d, hd)
    assert fp.dhidden_route(dq.dtype, d) == fp.TENSOR_CORE
    fp.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fp._dhidden_cuda(dq, dk, dv, w, w, w, cos, sin, hd)
    assert fp.launch_counts["prologue_dhidden"] == 0


@pytest.mark.cuda
@pytest.mark.parametrize("which", ["fwd", "dw"])
def test_tensor_core_fwd_and_dw_refuse_misaligned_operands_on_card(which):
    """On the tensor-core route the forward and dW read x (the norm pass's
    16-byte vectors) and every other operand by TMA or 16-byte vectors: an x
    one element off its allocation's start is refused before any launch;
    nothing falls back to SIMT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    hd, n, d = fp.KERNEL_HEAD_DIMS[0], 16, 64

    def arr(*shape):
        return torch.randn(*shape, device="cuda").to(torch.bfloat16)

    x = arr(n * d + 1)[1:].view(n, d)
    nw = torch.ones(d, device="cuda")
    w, dy, cos, sin = arr(d, hd), arr(n, hd), arr(n, hd), arr(n, hd)
    assert getattr(fp, f"{which}_route")(x.dtype, d) == fp.TENSOR_CORE
    fp.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        if which == "fwd":
            fp._fwd_cuda(x, nw, w, w, w, cos, sin, EPS, hd)
        else:
            fp._dw_cuda(x, nw, dy, dy, dy, cos, sin, EPS, hd)
    assert fp.launch_counts[f"prologue_{which}"] == 0
