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
    tfa.reset_launch_counts()
    q, k, v, _, _ = _inputs(1, 2, 2, 64, 16, False)
    tq, tk, tv = (torch.from_numpy(x.transpose(0, 2, 1, 3).copy()).requires_grad_()
                  for x in (q, k, v))
    tfa.flash_attention(tq, tk, tv).sum().backward()
    assert tfa.launch_counts == {"fwd": 0, "dq": 0, "dkv": 0}


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
