"""The port's flash attention against the JAX package's.

On the CPU the port's wrappers take the kernels' plain PyTorch versions; the
reference's Pallas kernels run in interpret mode. Same inputs (numpy seeds)
through both; fp32; tolerances stated per check. The CUDA kernels themselves
are held to the plain versions on the card (the `cuda` test below, and
chip_smoke.py).
"""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch.ops import flash_attention as tfa
from llama_pipeline_parallel_tpu_torch.ops.attention import attention as t_attention

# fp32 both sides; the two tile walks sum in different orders
TOL = dict(rtol=1e-5, atol=1e-5)
# gradients sum over more terms (kv tiles x q tiles)
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="session")
def ref():
    """The reference modules. The reference's host stash imports
    `jax._src.sharding_impls.TransferToMemoryKind`, which this jax lacks; a
    stand-in is installed first (only if missing). It is never constructed on
    the CPU: host transfers are gated off there."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    return types.SimpleNamespace(
        fa=importlib.import_module("llama_pipeline_parallel_tpu.ops.flash_attention"),
        attn=importlib.import_module("llama_pipeline_parallel_tpu.ops.attention"))


# (b, h, h_kv, s, hd, causal, q_offset, kv_offset, segmented)
CASES = {
    "causal_mha": (1, 2, 2, 64, 16, True, 0, 0, False),
    "causal_gqa": (2, 4, 2, 128, 32, True, 0, 0, False),
    "full_gqa": (2, 4, 2, 64, 16, False, 0, 0, False),
    "causal_gqa_segments": (2, 4, 2, 128, 16, True, 0, 0, True),
    "q_offset": (1, 4, 2, 64, 16, True, 32, 0, False),
    "kv_offset_empty_rows_segments": (2, 4, 1, 128, 16, True, 0, 64, True),
}


def _inputs(b, h, h_kv, s, hd, segmented, seed=0):
    """[b, h, s, hd] q / dO, [b, h_kv, s, hd] k / v, [b, s] int32 segment ids
    (two segments then a pad tail) or None."""
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, s, hd).astype(np.float32)
    k = rng.randn(b, h_kv, s, hd).astype(np.float32)
    v = rng.randn(b, h_kv, s, hd).astype(np.float32)
    do = rng.randn(b, h, s, hd).astype(np.float32)
    seg = None
    if segmented:
        seg = np.zeros((b, s), np.int32)
        cut = rng.randint(s // 4, s // 2, size=b)
        for i in range(b):
            seg[i, :cut[i]] = 1
            seg[i, cut[i]:s - s // 8] = 2
    return q, k, v, do, seg


def _ref_fwd(ref, q, k, v, seg, causal, q_off, kv_off):
    segs = None if seg is None else jnp.asarray(seg)[:, :, None]
    out, lse = ref.fa._fwd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
                           scale=q.shape[-1] ** -0.5, block_q=32, block_k=32,
                           q_offset=q_off, kv_offset=kv_off, segments_q=segs,
                           segments_kv=segs)
    return np.array(out), np.array(lse)  # writable copies


def _port_kw(q, seg, causal, q_off, kv_off):
    segs = None if seg is None else torch.from_numpy(seg)
    return dict(causal=causal, scale=q.shape[-1] ** -0.5, q_offset=q_off,
                kv_offset=kv_off, segments_q=segs, segments_kv=segs)


@pytest.mark.parametrize("case", list(CASES))
def test_fwd_matches_reference_pallas(ref, case):
    b, h, h_kv, s, hd, causal, q_off, kv_off, segmented = CASES[case]
    q, k, v, _, seg = _inputs(b, h, h_kv, s, hd, segmented)
    want_out, want_lse = _ref_fwd(ref, q, k, v, seg, causal, q_off, kv_off)
    out, lse = tfa._fwd(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                        **_port_kw(q, seg, causal, q_off, kv_off))
    np.testing.assert_allclose(out.numpy(), want_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), want_lse, **TOL)
    if case == "kv_offset_empty_rows_segments":
        empty = want_lse[..., 0] <= tfa.NEG_INF / 2
        assert empty.any()  # the empty-row contract is exercised
        assert (out.numpy()[empty] == 0).all() and (lse.numpy()[empty] == tfa.NEG_INF).all()


@pytest.mark.parametrize("case", list(CASES))
def test_bwd_matches_reference_pallas(ref, case):
    b, h, h_kv, s, hd, causal, q_off, kv_off, segmented = CASES[case]
    q, k, v, do, seg = _inputs(b, h, h_kv, s, hd, segmented)
    out, lse = _ref_fwd(ref, q, k, v, seg, causal, q_off, kv_off)
    group = h // h_kv
    k_full, v_full = np.repeat(k, group, axis=1), np.repeat(v, group, axis=1)
    delta = (do * out).sum(-1, keepdims=True)
    segs = None if seg is None else jnp.asarray(seg)[:, :, None]
    want = ref.fa._bwd(*(jnp.asarray(x) for x in (q, k_full, v_full, delta, lse, do)),
                       causal=causal, scale=hd ** -0.5, block_q=32, block_k=32,
                       q_offset=q_off, kv_offset=kv_off, segments_q=segs, segments_kv=segs)
    got = tfa._bwd(*(torch.from_numpy(x) for x in (q, k_full, v_full, delta, lse, do)),
                   **_port_kw(q, seg, causal, q_off, kv_off))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", list(CASES))
def test_autograd_matches_reference_exact_attention(ref, case):
    """The public op ([b, s, h, hd], autograd) against the reference's exact
    attention and its JAX gradients. Rows that see no key (pads, or rows the
    offsets put before every key) are left out: there exact attention softens
    to a uniform softmax while flash gives 0, both by contract."""
    b, h, h_kv, s, hd, causal, q_off, kv_off, segmented = CASES[case]
    q, k, v, do, seg = _inputs(b, h, h_kv, s, hd, segmented)
    q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v, do))  # [b, s, h, hd]
    _, lse = _ref_fwd(ref, q.transpose(0, 2, 1, 3), k.transpose(0, 2, 1, 3),
                      v.transpose(0, 2, 1, 3), seg, causal, q_off, kv_off)
    live = (lse[..., 0] > tfa.NEG_INF / 2).transpose(0, 2, 1)[..., None]  # [b, s, h, 1]
    do = do * live
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    mask = None if seg is None else seg

    def ref_loss(q_, k_, v_):
        out = ref.attn.attention(q_, k_, v_, None if mask is None else jnp.asarray(mask), **kw)
        return jnp.sum(out * do), out

    (_, want_out), want_grads = jax.value_and_grad(ref_loss, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = tfa.flash_attention(tq, tk, tv, None if mask is None else torch.from_numpy(mask), **kw)
    (out * torch.from_numpy(do)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy() * live, np.asarray(want_out) * live, **TOL)
    for name, g, w in zip(("dq", "dk", "dv"), (tq.grad, tk.grad, tv.grad), want_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name, **GRAD_TOL)


def test_port_exact_attention_matches_flash_plain_on_live_rows():
    """The port's two attention paths agree with each other (no reference
    involved): the flash op on the CPU is the plain tiled version."""
    q, k, v, _, seg = _inputs(2, 4, 2, 96, 16, True, seed=3)
    q, k, v = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()) for x in (q, k, v))
    mask = torch.from_numpy(seg)
    live = (mask != 0)[:, :, None, None]
    got = tfa.flash_attention(q, k, v, mask)
    want = t_attention(q, k, v, mask)
    torch.testing.assert_close(got * live, want * live, **TOL)


def test_cpu_path_launches_no_kernel():
    """On the CPU the op takes the plain versions: no kernel launch and no
    tensor-core call is counted, in fp32 and in bf16 (the tensor cores'
    dtype)."""
    tfa.reset_launch_counts()
    q, k, v, _, _ = _inputs(1, 2, 2, 64, 16, False)
    for dtype in (torch.float32, torch.bfloat16):
        tq, tk, tv = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()).to(dtype)
                      .requires_grad_() for x in (q, k, v))
        tfa.flash_attention(tq, tk, tv).float().sum().backward()
    assert tfa.launch_counts == {"fwd": 0, "dq": 0, "dkv": 0}
    assert tfa.tensor_core_counts == {"fwd": 0, "dq": 0, "dkv": 0}


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype,route", [(torch.bfloat16, "tensor_core"),
                                         (torch.float32, "simt")])
def test_route_by_dtype(which, dtype, route):
    """Each pass's route is a pure function of dtype and head_dim, fixed
    before any launch: bf16 with head_dim 128 on the tensor cores,
    fp32 on the SIMT kernels (wgmma on fp32 would be TF32)."""
    assert getattr(tfa, f"{which}_route")(dtype, 128) == route
    assert route == (tfa.TENSOR_CORE if dtype == torch.bfloat16 else tfa.SIMT)


@pytest.mark.parametrize("which", ["fwd", "dq", "dkv"])
@pytest.mark.parametrize("dtype,hd", [(torch.bfloat16, 64), (torch.bfloat16, 256),
                                      (torch.float32, 96), (torch.float16, 128)])
def test_route_refuses_other_head_dims_and_dtypes(which, dtype, hd):
    with pytest.raises(ValueError, match="head_dim" if dtype != torch.float16 else "bfloat16"):
        getattr(tfa, f"{which}_route")(dtype, hd)


@pytest.mark.parametrize("kernel", ["fwd_kernel<float, 128>", "bwd_dq_kernel<float, 128>",
                                    "bwd_dq_kernel<__nv_bfloat16, 128>",
                                    "bwd_dkv_kernel<float, 128>", "fwd_tc_kernel",
                                    "bwd_dq_tc_kernel", "bwd_dkv_tc_kernel"])
def test_step_profile_counts_every_flash_kernel_in_flash_attention(kernel):
    """tools/torch_step_profile.py files each flash kernel, SIMT or
    tensor-core, under the `flash_attention` family, by its name as the
    profiler shows it."""
    from tools import torch_step_profile

    name = f"void (anonymous namespace)::{kernel}(CUtensorMap_st, int)"
    assert torch_step_profile.family(name) == "flash_attention"


def test_reset_launch_counts_zeroes_tensor_core_counts():
    for key in tfa.tensor_core_counts:
        tfa.tensor_core_counts[key] += 3
    tfa.reset_launch_counts()
    assert tfa.tensor_core_counts == {"fwd": 0, "dq": 0, "dkv": 0}


def test_wrappers_refuse_what_the_kernels_do_not_take():
    """Off the CPU the wrappers launch a kernel or raise; they never fall back
    to the plain version."""
    meta = torch.empty((1, 2, 64, 128), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._fwd(meta, meta, meta, causal=True, scale=1.0)
    cpu = torch.zeros((1, 2, 64, 128))
    kw = dict(causal=True, scale=1.0, q_offset=0, kv_offset=0, segments_q=None,
              segments_kv=None)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._fwd_cuda(cpu, cpu, cpu, **kw)
    with pytest.raises(ValueError, match="cuda or cpu"):
        tfa._bwd_dq_cuda(cpu, cpu, cpu, cpu[..., :1], cpu[..., :1], cpu, **kw)
    with pytest.raises(ValueError, match="given together"):
        tfa._fwd(cpu, cpu, cpu, causal=True, scale=1.0,
                 segments_q=torch.ones((1, 64), dtype=torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernels_match_plain_on_card(dtype):
    """The CUDA kernels against their plain versions (fp32 math) on the card,
    GQA + segments + offsets. bf16 outputs, element by element: rounding to
    bf16 costs at most 2^-8 of the element's size, plus 2^-8 of the tensor's
    rms near zero for fp32 summation order; lse (fp32) and fp32 outputs:
    summation order."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    dt = getattr(torch, dtype)
    q, k, v, do, seg = _inputs(2, 8, 2, 256, 128, True, seed=5)
    q, k, v, do = (torch.from_numpy(x).cuda().to(dt) for x in (q, k, v, do))
    kw = _port_kw(q, seg, True, 64, 128)
    kw["segments_q"] = kw["segments_kv"] = kw["segments_q"].cuda()
    k_full, v_full = (x.repeat_interleave(4, dim=1).contiguous() for x in (k, v))
    out, lse = tfa._fwd_cuda(q, k, v, **kw)
    want_out, want_lse = tfa._fwd_plain(q.float(), k.float(), v.float(), **kw)
    delta = (do.float() * want_out).sum(-1, keepdim=True)
    got = (out, lse, tfa._bwd_dq_cuda(q, k_full, v_full, delta, want_lse, do, **kw),
           *tfa._bwd_dkv_cuda(q, k_full, v_full, delta, want_lse, do, **kw))
    f32 = [x.float() for x in (q, k_full, v_full, delta, want_lse, do)]
    want = (want_out, want_lse, tfa._bwd_dq_plain(*f32, **kw), *tfa._bwd_dkv_plain(*f32, **kw))
    torch.cuda.synchronize()
    for name, g, w in zip(("out", "lse", "dq", "dk", "dv"), got, want):
        rtol, atol = 0.0, 1e-4
        if dtype == "bfloat16" and name != "lse":
            rtol = 2 ** -8
            atol = rtol * w.float().square().mean().sqrt().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.cuda
def test_autograd_op_on_card_matches_cpu():
    """The public op on the card (forward + dq + dk/dv kernels, GQA group sum,
    segment ids) against the same op on the CPU (plain versions); fp32,
    summation order only."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    q, k, v, do, seg = _inputs(2, 8, 2, 192, 128, True, seed=7)
    q, k, v, do = (x.transpose(0, 2, 1, 3).copy() for x in (q, k, v, do))  # [b, s, h, hd]
    results = []
    for device in ("cpu", "cuda"):
        tq, tk, tv = (torch.from_numpy(x).to(device).requires_grad_() for x in (q, k, v))
        out = tfa.flash_attention(tq, tk, tv, torch.from_numpy(seg).to(device))
        (out * torch.from_numpy(do).to(device)).sum().backward()
        results.append([t.detach().cpu() for t in (out, tq.grad, tk.grad, tv.grad)])
    for name, cpu, card in zip(("out", "dq", "dk", "dv"), *results):
        torch.testing.assert_close(card, cpu, rtol=1e-4, atol=1e-5, msg=name)


# The tensor-core route (bf16) at ragged shapes:
# (b, h, h_kv, sq, skv, causal, q_offset, kv_offset, segmented). sq and skv
# are multiples of none of 32, 64 and 128 (the kernels' q and kv tiles); segments come
# from the global positions (two segments, then a pad tail), so some rows
# see no key; offsets put some rows before every key.
TC_CASES = {
    "ragged_causal": (1, 4, 4, 200, 200, True, 0, 0, False),
    "ring_slab_sq_ne_skv": (1, 4, 4, 136, 330, True, 300, 40, False),
    "gqa4_segments_offsets": (2, 8, 2, 300, 300, True, 64, 128, True),
    "gqa4_full_sq_ne_skv_segments": (2, 8, 2, 100, 260, False, 0, 0, True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(TC_CASES))
def test_tensor_core_kernels_match_plain_on_card(case):
    """bf16 forward, dq and dk/dv on the tensor cores (the route asserted
    through `tensor_core_counts`) against their plain versions in fp32 math
    on the same inputs, element by element: out, dq, dk and dv to 2^-8 |ref|
    + 2^-8 rms(ref) (bf16 rounding of the output, of P, dS and dS^T before
    their products), lse to 1e-4 absolute (fp32 summation order). The
    empty-row contract holds exactly: out 0, lse NEG_INF and dq 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    b, h, h_kv, sq, skv, causal, q_off, kv_off, segmented = TC_CASES[case]
    rng = np.random.RandomState(11)

    def randn(*shape):
        return torch.from_numpy(rng.randn(*shape).astype(np.float32)).cuda().bfloat16()

    q, k, v, do = randn(b, h, sq, 128), randn(b, h_kv, skv, 128), randn(b, h_kv, skv, 128), \
        randn(b, h, sq, 128)
    seg_q = seg_kv = None
    if segmented:
        n = max(q_off + sq, kv_off + skv)
        seg = np.zeros((b, n), np.int32)
        for i in range(b):
            cut = rng.randint(n // 4, n // 2)
            seg[i, :cut], seg[i, cut:n - n // 8] = 1, 2
        seg_q = torch.from_numpy(seg[:, q_off:q_off + sq].copy()).cuda()
        seg_kv = torch.from_numpy(seg[:, kv_off:kv_off + skv].copy()).cuda()
    kw = dict(causal=causal, scale=128 ** -0.5, q_offset=q_off, kv_offset=kv_off,
              segments_q=seg_q, segments_kv=seg_kv)
    group = h // h_kv
    k_full, v_full = (x.repeat_interleave(group, dim=1).contiguous() for x in (k, v))
    tfa.reset_launch_counts()
    out, lse = tfa._fwd_cuda(q, k, v, **kw)
    want_out, want_lse = tfa._fwd_plain(q.float(), k.float(), v.float(), **kw)
    delta = (do.float() * want_out).sum(-1, keepdim=True)
    dq = tfa._bwd_dq_cuda(q, k_full, v_full, delta, want_lse, do, **kw)
    dk, dv = tfa._bwd_dkv_cuda(q, k_full, v_full, delta, want_lse, do, **kw)
    f32 = [x.float() for x in (q, k_full, v_full, delta, want_lse, do)]
    want_dq = tfa._bwd_dq_plain(*f32, **kw)
    want_dk, want_dv = tfa._bwd_dkv_plain(*f32, **kw)
    torch.cuda.synchronize()
    assert tfa.fwd_route(q.dtype, 128) == tfa.dq_route(q.dtype, 128) \
        == tfa.dkv_route(q.dtype, 128) == tfa.TENSOR_CORE
    assert tfa.tensor_core_counts == {"fwd": 1, "dq": 1, "dkv": 1}
    empty = want_lse[..., 0] <= tfa.NEG_INF / 2
    if case == "gqa4_segments_offsets":
        assert empty.any()  # pads, and rows before every key: the contract is exercised
    assert (out[empty] == 0).all() and (lse[empty] == tfa.NEG_INF).all()
    assert (dq[empty] == 0).all()
    torch.testing.assert_close(lse, want_lse, rtol=0.0, atol=1e-4, msg="lse")
    for name, g, w in (("out", out, want_out), ("dq", dq, want_dq), ("dk", dk, want_dk),
                       ("dv", dv, want_dv)):
        rtol = 2 ** -8
        atol = rtol * w.float().square().mean().sqrt().item()
        torch.testing.assert_close(g.float(), w.float(), rtol=rtol, atol=atol, msg=name)


@pytest.mark.cuda
def test_tensor_core_route_refuses_misaligned_operands_on_card():
    """TMA reads 16-byte aligned tensors only: the tensor-core route of each
    pass raises on a misaligned q; it never falls back to SIMT."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    flat = torch.randn(1 * 2 * 64 * 128 + 1, device="cuda").bfloat16()
    q = flat[1:].view(1, 2, 64, 128)  # contiguous, 2 bytes off the allocation
    k = torch.randn(1, 2, 64, 128, device="cuda").bfloat16()
    kw = dict(causal=True, scale=1.0, q_offset=0, kv_offset=0, segments_q=None,
              segments_kv=None)
    tfa.reset_launch_counts()
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._fwd_cuda(q, k, k, **kw)
    lse = torch.zeros((1, 2, 64, 1), device="cuda")
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._bwd_dq_cuda(q, k, k, lse, lse, k, **kw)
    with pytest.raises(ValueError, match="16-byte aligned"):
        tfa._bwd_dkv_cuda(q, k, k, lse, lse, k, **kw)
    assert tfa.launch_counts == {"fwd": 0, "dq": 0, "dkv": 0}
