"""The port's fused CE head (ops/fused_ce.py) against the JAX package's
Pallas CE kernels (ops/pallas_ce.py, run in interpret mode on the CPU), on
the same numpy inputs: each kernel's plain version against its TPU kernel,
and the public op's loss and gradients against `pallas_ce_sum_count`'s. On a
card, each CUDA kernel against its plain version.

Tolerances: fp32 rtol 1e-5 on the loss and its statistics, 1e-4 on the
gradients (summation order over 48-wide products and 256-wide vocab sums).
bf16: the inputs are the same bf16 values and both sides compute in fp32,
so the loss keeps rtol 1e-5; each gradient is rounded to bf16 at the end
(and g before the products) on both sides, so an element may land one bf16
step away: rtol 2^-7 plus an atol of 2^-7 x the gradient's rms for elements
near zero.
"""

import ctypes
import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch.ops import fused_ce as fc
from llama_pipeline_parallel_tpu_torch.ops.cross_entropy import fused_ce_sum_count

N_ROWS, SEQ, D, V = 2, 32, 48, 256  # 64 tokens: one Pallas token block
FP32_LOSS = dict(rtol=1e-5, atol=1e-6)
FP32_GRAD = dict(rtol=1e-4, atol=1e-6)
BF16_STEP = 2.0 ** -7


@pytest.fixture(scope="session")
def ref():
    """The reference's Pallas CE module, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (imported by the reference's host stash, never constructed on the CPU)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    return types.SimpleNamespace(
        pce=importlib.import_module("llama_pipeline_parallel_tpu.ops.pallas_ce"))


def _inputs(num_chunks, seed=0, shape=(N_ROWS, SEQ, D, V)):
    """h [2, 32, 48], w [48, 256] fp32 (or `shape` = rows, seq, d, V) and
    targets [rows, seq] int32 with ignored tokens, the last vocab column, and
    both sides of every chunk boundary."""
    rows, seq, d, v = shape
    rng = np.random.RandomState(seed)
    h = rng.randn(rows, seq, d).astype(np.float32)
    w = (0.1 * rng.randn(d, v)).astype(np.float32)
    t = rng.randint(0, v, size=(rows, seq)).astype(np.int32)
    vc = v // num_chunks
    edges = [v - 1, v - 2, 0, vc - 1, vc, 2 * vc - 1, 2 * vc, 3 * vc - 1, 3 * vc]
    t[0, :len(edges)] = edges
    t[0, -3:] = fc.IGNORE_INDEX
    t[1, :4] = fc.IGNORE_INDEX
    return h, w, t


def _flat(h, t):
    """(hN, safe_t, valid) as both packages' kernels take them."""
    tN = t.reshape(-1)
    valid = tN != fc.IGNORE_INDEX
    return h.reshape(-1, h.shape[-1]), np.where(valid, tN, 0).astype(np.int32), valid


def _bf16_close(got: torch.Tensor, want: np.ndarray, what: str) -> None:
    want = np.asarray(want, np.float32)
    atol = BF16_STEP * float(np.sqrt(np.mean(want ** 2)))
    np.testing.assert_allclose(got.float().numpy(), want, rtol=BF16_STEP, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# each plain version against its Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("num_chunks", [1, 4])
def test_fwd_stats_plain_matches_pallas_kernel(ref, num_chunks):
    h, w, t = _inputs(num_chunks)
    hN, safe_t, _ = _flat(h, t)
    want_lse, want_tgt = ref.pce._fwd_stats(jnp.asarray(hN), jnp.asarray(w),
                                            jnp.asarray(safe_t), num_chunks, None)
    lse, tgt = fc._fwd_stats_plain(torch.from_numpy(hN), torch.from_numpy(w),
                                   torch.from_numpy(safe_t), num_chunks)
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), **FP32_LOSS)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(want_tgt), **FP32_LOSS)


@pytest.mark.parametrize("num_chunks,ct", [(1, 1.0), (1, 0.37), (4, 1.0), (4, 0.37)])
def test_dh_dw_plain_match_pallas_kernels(ref, num_chunks, ct):
    """The dh and dW plain versions against `_backward`'s two kernels, given
    the same lse, on tokens some of which are ignored; cotangent `ct`."""
    h, w, t = _inputs(num_chunks, seed=1)
    hN, safe_t, valid = _flat(h, t)
    lse, _ = fc._fwd_stats_plain(torch.from_numpy(hN), torch.from_numpy(w),
                                 torch.from_numpy(safe_t), num_chunks)
    want_dh, want_dw = ref.pce._backward(jnp.asarray(h), jnp.asarray(w), jnp.asarray(t),
                                         jnp.asarray(lse.numpy()), jnp.asarray(valid),
                                         jnp.float32(ct), num_chunks, None)
    args = (torch.from_numpy(hN), torch.from_numpy(w), torch.from_numpy(safe_t), lse,
            torch.from_numpy(valid).float() * ct, num_chunks)
    np.testing.assert_allclose(fc._dh_plain(*args).numpy(),
                               np.asarray(want_dh).reshape(hN.shape), **FP32_GRAD)
    np.testing.assert_allclose(fc._dw_plain(*args).numpy(), np.asarray(want_dw), **FP32_GRAD)


def test_dh_dw_plain_match_pallas_kernels_at_tensor_core_shape_bf16(ref):
    """bf16 at the shape ragged to every tile of the tensor-core route (300
    tokens, width 200, vocab 1088 in 4 chunks of 272, all multiples of 8):
    the plain dh and dW against `_backward`'s two kernels on the same bf16
    values and lse. Both sides round g to bf16 before the products; the
    reference rounds dh and dW to bf16 at the end, the plain versions keep
    fp32, so an element may land one bf16 step away."""
    num_chunks = 4
    h, w, t = _inputs(num_chunks, seed=5, shape=(2, 150, 200, 1088))
    hN, safe_t, valid = _flat(h, t)
    th, tw = (torch.from_numpy(x).to(torch.bfloat16) for x in (hN, w))
    lse, _ = fc._fwd_stats_plain(th, tw, torch.from_numpy(safe_t), num_chunks)
    jh, jw = (jnp.asarray(x, jnp.bfloat16) for x in (h, w))
    want_dh, want_dw = ref.pce._backward(jh, jw, jnp.asarray(t), jnp.asarray(lse.numpy()),
                                         jnp.asarray(valid), jnp.float32(0.37), num_chunks, None)
    args = (th, tw, torch.from_numpy(safe_t), lse, torch.from_numpy(valid).float() * 0.37,
            num_chunks)
    assert fc.backward_route(th.dtype, hN.shape[1], w.shape[1] // num_chunks) == fc.TENSOR_CORE
    _bf16_close(fc._dh_plain(*args), np.asarray(want_dh, np.float32).reshape(hN.shape), "dh")
    _bf16_close(fc._dw_plain(*args), np.asarray(want_dw, np.float32), "dW")


@pytest.mark.parametrize("dtype,d,vc,route", [
    (torch.bfloat16, 4096, 8000, fc.TENSOR_CORE),   # the slice: V 32000 in 4 chunks
    (torch.bfloat16, 4096, 4000, fc.TENSOR_CORE),   # 32000 in 8 chunks
    (torch.bfloat16, 200, 272, fc.TENSOR_CORE),     # the ragged card case
    (torch.float32, 4096, 8000, fc.SIMT),           # wgmma on fp32 would be TF32
    (torch.float32, 200, 250, fc.SIMT),
    (torch.bfloat16, 4100, 8000, fc.SIMT),          # d % 8 != 0: rows not 16-byte strided
    (torch.bfloat16, 4096, 250, fc.SIMT),           # vc % 8 != 0: W + c0 off 16 bytes
])
def test_backward_route_by_dtype_and_shape(dtype, d, vc, route):
    assert fc.backward_route(dtype, d, vc) == route


@pytest.mark.parametrize("dtype,d,v,route", [
    (torch.bfloat16, 4096, 32000, fc.TENSOR_CORE),  # the slice's head
    (torch.bfloat16, 200, 1000, fc.TENSOR_CORE),    # the ragged card case (backward: SIMT)
    (torch.bfloat16, 200, 1088, fc.TENSOR_CORE),
    (torch.float32, 4096, 32000, fc.SIMT),          # wgmma on fp32 would be TF32
    (torch.bfloat16, 200, 1004, fc.SIMT),           # V % 8 != 0: W's rows not 16-byte strided
    (torch.bfloat16, 4100, 32000, fc.SIMT),         # d % 8 != 0: h's rows not 16-byte strided
])
def test_forward_route_by_dtype_and_shape(dtype, d, v, route):
    assert fc.forward_route(dtype, d, v) == route


@pytest.mark.parametrize("kernel", [
    "ce_stats_kernel", "ce_lse_kernel", "ce_grad_kernel", "ce_dh_kernel", "ce_dw_kernel",
    "ce_stats_tc_kernel", "ce_grad_tc_kernel", "ce_dh_tc_kernel", "ce_dw_tc_kernel"])
def test_step_profile_counts_every_ce_kernel_in_ce_head(kernel):
    """tools/torch_step_profile.py files each CE kernel, SIMT or tensor-core,
    under the `ce_head` family, by its name as the profiler shows it."""
    from tools import torch_step_profile

    name = f"void (anonymous namespace)::{kernel}<__nv_bfloat16>(CUtensorMap_st, int)"
    assert torch_step_profile.family(name) == "ce_head"


def test_reset_launch_counts_zeroes_tensor_core_counts():
    fc.launch_counts["ce_dh"] += 2
    fc.tensor_core_counts["ce_dw"] += 3
    fc.tensor_core_counts["ce_fwd"] += 1
    fc.reset_launch_counts()
    assert fc.launch_counts == {"ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}
    assert fc.tensor_core_counts == {"ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}


# ---------------------------------------------------------------------------
# the public op against pallas_ce_sum_count
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("num_chunks", [1, 4])
def test_kernel_ce_sum_count_matches_pallas(ref, num_chunks, dtype):
    """Loss sum, count, dh and dW of 0.37 * loss_sum (a cotangent that is
    not 1) against jax.value_and_grad of the reference's custom VJP."""
    h, w, t = _inputs(num_chunks, seed=2)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)

    def ref_loss(h_, w_):
        loss_sum, count = ref.pce.pallas_ce_sum_count(h_, w_, jnp.asarray(t), num_chunks)
        return 0.37 * loss_sum, (loss_sum, count)

    (_, (want_sum, want_count)), (want_dh, want_dw) = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(h, jdt), jnp.asarray(w, jdt))
    th = torch.from_numpy(h).to(tdt).requires_grad_()
    tw = torch.from_numpy(w).to(tdt).requires_grad_()
    got_sum, got_count = fc.kernel_ce_sum_count(th, tw, torch.from_numpy(t).long(), num_chunks)
    (0.37 * got_sum).backward()
    assert int(got_count) == int(want_count) == N_ROWS * SEQ - 7
    assert got_sum.dtype == torch.float32
    assert (th.grad.dtype, tw.grad.dtype) == (tdt, tdt)
    np.testing.assert_allclose(got_sum.item(), float(want_sum), **FP32_LOSS)
    if dtype == "float32":
        np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_dh), **FP32_GRAD)
        np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_dw), **FP32_GRAD)
    else:
        _bf16_close(th.grad, want_dh, "dh")
        _bf16_close(tw.grad, want_dw, "dW")


def test_kernel_ce_matches_chunked_op_and_dense_cross_entropy():
    """On the CPU the kernel head equals the vocab-chunked op and the dense
    cross-entropy on materialised logits, values and gradients (fp32)."""
    h, w, t = _inputs(4, seed=3)
    tt = torch.from_numpy(t).long()
    results = []
    for op in ("kernel", "chunked", "dense"):
        th = torch.from_numpy(h).requires_grad_()
        tw = torch.from_numpy(w).requires_grad_()
        if op == "kernel":
            loss, count = fc.kernel_ce_sum_count(th, tw, tt, 4)
        elif op == "chunked":
            loss, count = fused_ce_sum_count(th, tw, tt, 4)
        else:
            loss = torch.nn.functional.cross_entropy(
                (th @ tw).reshape(-1, V), tt.reshape(-1), ignore_index=fc.IGNORE_INDEX,
                reduction="sum")
            count = (tt != fc.IGNORE_INDEX).sum()
        loss.backward()
        results.append((loss.detach(), int(count), th.grad, tw.grad))
    for loss, count, dh, dw in results[1:]:
        torch.testing.assert_close(results[0][0], loss, **FP32_LOSS)
        assert results[0][1] == count
        torch.testing.assert_close(results[0][2], dh, **FP32_GRAD)
        torch.testing.assert_close(results[0][3], dw, **FP32_GRAD)


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """The CUDA wrappers raise on CPU tensors (the plain path is chosen by
    device before them, never as a fallback) and on a chunk count that does
    not divide the vocab; nothing is built for that."""
    h, w, t = _inputs(4)
    hN, safe_t, valid = _flat(h, t)
    hN, w, safe_t = torch.from_numpy(hN), torch.from_numpy(w), torch.from_numpy(safe_t)
    lse = torch.zeros(hN.shape[0])
    with pytest.raises(ValueError, match="cuda or cpu"):
        fc._fwd_stats_cuda(hN, w, safe_t, 4)
    with pytest.raises(ValueError, match="cuda or cpu"):
        fc._backward_cuda(hN, w, safe_t, lse, lse, 4)
    with pytest.raises(ValueError, match="not divisible"):
        fc.kernel_ce_sum_count(hN, w, torch.from_numpy(t).long(), 3)
    with pytest.raises(ValueError, match="not divisible"):
        fc._fwd_stats_plain(hN, w, safe_t, 0)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype,v", [
    pytest.param("float32", 1000, id="float32"),
    pytest.param("bfloat16", 1000, id="bfloat16"),
    pytest.param("float32", 1088, id="float32-aligned"),
    pytest.param("bfloat16", 1088, id="bfloat16-aligned"),
    pytest.param("bfloat16", 1004, id="bfloat16-v1004"),
])
def test_kernels_match_plain_on_card(dtype, v):
    """Each CUDA kernel against its plain version on a shape ragged to every
    tile (300 tokens, width 200, vocab 1000 in 4 chunks of 250, 1088 in
    chunks of 272, or 1004 in chunks of 251), with ignored tokens and
    targets on the chunk edges and in the last vocab tile. Each call's route
    is asserted: bf16 takes the tensor-core forward where V is a multiple of
    8 (1000, 1088) and the tensor-core backward where the chunk is (272);
    fp32 and the rest take the SIMT kernels.
    fp32: 1e-4 absolute (fp32 summation order). bf16: the plain version on
    the same bf16 values in fp32 with g rounded to bf16; the kernel's bf16 dW
    may be one rounding (2^-8 relative) away."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(4)
    n, d, chunks = 300, 200, 4
    vc = v // chunks
    tdt = getattr(torch, dtype)
    h = torch.from_numpy(rng.randn(n, d).astype(np.float32)).to("cuda", tdt)
    w = torch.from_numpy((0.3 * rng.randn(d, v)).astype(np.float32)).to("cuda", tdt)
    t = rng.randint(0, v, size=n)
    t[:9] = [v - 1, v - 2, 0, vc - 1, vc, 2 * vc - 1, 2 * vc, 3 * vc - 1, 3 * vc]
    t[-6:] = fc.IGNORE_INDEX
    t = torch.from_numpy(t).cuda()
    valid = t != fc.IGNORE_INDEX
    safe_t = torch.where(valid, t, 0).to(torch.int32)
    svec = valid.float() * 0.37
    hf, wf = h.float(), w.float()
    fc.reset_launch_counts()
    lse, tgt = fc._fwd_stats_cuda(h, w, safe_t, chunks)
    ref_lse, ref_tgt = fc._fwd_stats_plain(hf, wf, safe_t, chunks)
    dh, dw = fc._backward_cuda(h, w, safe_t, ref_lse, svec, chunks)
    ref_dh = fc._dh_plain(hf, wf, safe_t, ref_lse, svec, chunks, g_dtype=tdt)
    ref_dw = fc._dw_plain(hf, wf, safe_t, ref_lse, svec, chunks, g_dtype=tdt)
    torch.cuda.synchronize()
    assert fc.launch_counts == {"ce_fwd": 1, "ce_dh": 1, "ce_dw": 1}
    fwd_tc = int(fc.forward_route(tdt, d, v) == fc.TENSOR_CORE)
    bwd_tc = int(fc.backward_route(tdt, d, vc) == fc.TENSOR_CORE)
    assert fwd_tc == int(dtype == "bfloat16" and v in (1000, 1088))
    assert bwd_tc == int(dtype == "bfloat16" and v == 1088)
    assert fc.tensor_core_counts == {"ce_fwd": fwd_tc, "ce_dh": bwd_tc, "ce_dw": bwd_tc}
    torch.testing.assert_close(lse, ref_lse, rtol=0, atol=1e-4)
    torch.testing.assert_close(tgt, ref_tgt, rtol=0, atol=1e-4)
    torch.testing.assert_close(dh, ref_dh, rtol=0, atol=1e-4)
    rtol = 0 if dtype == "float32" else 2.0 ** -8
    torch.testing.assert_close(dw.float(), ref_dw, rtol=rtol, atol=1e-4)


@pytest.mark.cuda
def test_tensor_core_routes_refuse_misaligned_operands_on_card():
    """On the tensor-core routes h and w must be 16-byte aligned (TMA): a
    view one element off the allocation's start is refused before any
    launch, forward and backward; nothing falls back to SIMT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    n, d, v, chunks = 64, 64, 256, 1
    h = torch.randn(n * d + 1, device="cuda").to(torch.bfloat16)[1:].view(n, d)
    w = torch.randn(d, v, device="cuda").to(torch.bfloat16)
    safe_t = torch.zeros(n, dtype=torch.int32, device="cuda")
    lse = torch.zeros(n, device="cuda")
    assert fc.forward_route(h.dtype, d, v) == fc.backward_route(h.dtype, d, v) == fc.TENSOR_CORE
    fc.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        fc._fwd_stats_cuda(h, w, safe_t, chunks)
    with pytest.raises(ValueError, match="16-byte aligned"):
        fc._backward_cuda(h, w, safe_t, lse, lse, chunks)
    assert fc.launch_counts == {"ce_fwd": 0, "ce_dh": 0, "ce_dw": 0}


def _tc_matmul(a, b, m, n, k, a_mn, b_mn):
    """The tensor-core mainloop alone (`lpt_tc_matmul` of the test library
    `csrc/tc_matmul.cu`): fp32 [m, n] = A B^T."""
    from llama_pipeline_parallel_tpu_torch.ops import kernel_build

    lib = kernel_build.load("tc_matmul")
    lib.lpt_tc_matmul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.lpt_tc_matmul_error_string.restype = ctypes.c_char_p
    c = torch.full((m, n), float("nan"), device="cuda")
    err = lib.lpt_tc_matmul(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, a_mn, b_mn,
                            torch.cuda.current_stream().cuda_stream)
    assert err == 0, lib.lpt_tc_matmul_error_string(err).decode()
    return c


@pytest.mark.cuda
@pytest.mark.parametrize("a_mn,b_mn", [
    pytest.param(0, 1, id="K-MN-grad"),   # h @ W_c: h K-major, W_c MN-major
    pytest.param(0, 0, id="K-K-dh"),      # g @ W_c^T: both K-major
    pytest.param(1, 1, id="MN-MN-dw"),    # h^T @ g: both MN-major
])
@pytest.mark.parametrize("m,n,k", [(296, 272, 200), (1024, 1280, 1000)])
def test_tensor_core_mainloop_matches_matmul_on_card(a_mn, b_mn, m, n, k):
    """The bare tensor-core mainloop (TMA ring, wgmma, plain fp32 store) for
    each operand layout pair the CE backward uses, against torch.matmul in
    fp32 on the same bf16 values: ragged to every tile and depth (296 x 272
    x 200; 128 x 256 block tiles), and 16 depth steps through the 4-stage
    ring. Products of bf16 values are exact in fp32; only the summation
    order differs: 1e-3 absolute on sums of up to 1000 products of unit
    normals (~30 in size)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.RandomState(6)
    A = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to("cuda", torch.bfloat16)
    B = torch.from_numpy(rng.randn(n, k).astype(np.float32)).to("cuda", torch.bfloat16)
    a = A.T.contiguous() if a_mn else A
    b = B.T.contiguous() if b_mn else B
    got = _tc_matmul(a, b, m, n, k, a_mn, b_mn)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, A.float() @ B.float().T, rtol=0, atol=1e-3)
