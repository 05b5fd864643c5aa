"""The port's rmsnorm, rope, exact attention and fused CE against the JAX
package's, on the same numpy inputs (fp32 unless stated)."""

import importlib
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from llama_pipeline_parallel_tpu_torch.ops.attention import attention
from llama_pipeline_parallel_tpu_torch.ops.cross_entropy import IGNORE_INDEX, fused_ce_sum_count
from llama_pipeline_parallel_tpu_torch.ops.rmsnorm import rms_norm
from llama_pipeline_parallel_tpu_torch.ops.rope import apply_rope, rope_cos_sin

# fp32 elementwise ops: a few ulps (rsqrt / sin / cos implementations differ)
TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(scope="session")
def ref():
    """The reference modules, after installing the stand-in for
    `jax._src.sharding_impls.TransferToMemoryKind` where this jax lacks it
    (imported by the reference's host stash, never constructed on the CPU)."""
    import jax._src.sharding_impls as impls

    if not hasattr(impls, "TransferToMemoryKind"):
        class TransferToMemoryKind:
            def __init__(self, memory_kind):
                self.memory_kind = memory_kind

        impls.TransferToMemoryKind = TransferToMemoryKind
    mods = {"rms": "ops.rmsnorm", "rope": "ops.rope", "attn": "ops.attention",
            "ce": "ops.cross_entropy"}
    return types.SimpleNamespace(**{
        k: importlib.import_module(f"llama_pipeline_parallel_tpu.{v}") for k, v in mods.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm(ref, dtype):
    rng = np.random.RandomState(0)
    x = rng.randn(2, 8, 64).astype(np.float32)
    w = (1 + 0.1 * rng.randn(64)).astype(np.float32)
    want = ref.rms.rms_norm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(w), 1e-6)
    got = rms_norm(torch.from_numpy(x).to(getattr(torch, dtype)), torch.from_numpy(w), 1e-6)
    assert got.dtype == getattr(torch, dtype)
    # bf16: both round the same fp32 value to bf16; allow one bf16 ulp
    tol = TOL if dtype == "float32" else dict(rtol=2 ** -7, atol=0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def test_rope(ref):
    rng = np.random.RandomState(1)
    pos = np.stack([np.arange(16), np.arange(100, 116)]).astype(np.int32)
    q = rng.randn(2, 16, 4, 32).astype(np.float32)
    k = rng.randn(2, 16, 2, 32).astype(np.float32)
    wc, ws = ref.rope.rope_cos_sin(jnp.asarray(pos), 32, 10000.0)
    tc, ts = rope_cos_sin(torch.from_numpy(pos), 32, 10000.0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(wc), **TOL)
    np.testing.assert_allclose(ts.numpy(), np.asarray(ws), **TOL)
    wq, wk = ref.rope.apply_rope(jnp.asarray(q), jnp.asarray(k), wc, ws)
    tq, tk = apply_rope(torch.from_numpy(q), torch.from_numpy(k), tc, ts)
    np.testing.assert_allclose(tq.numpy(), np.asarray(wq), **TOL)
    np.testing.assert_allclose(tk.numpy(), np.asarray(wk), **TOL)


@pytest.mark.parametrize("causal,q_off,kv_off,segmented,h_kv", [
    (True, 0, 0, False, 4),
    (True, 0, 0, True, 2),
    (False, 0, 0, True, 1),
    (True, 16, 0, False, 2),
])
def test_exact_attention(ref, causal, q_off, kv_off, segmented, h_kv):
    rng = np.random.RandomState(2)
    q = rng.randn(2, 32, 4, 16).astype(np.float32)
    k = rng.randn(2, 32, h_kv, 16).astype(np.float32)
    v = rng.randn(2, 32, h_kv, 16).astype(np.float32)
    mask = None
    if segmented:
        mask = np.zeros((2, 32), np.int32)
        mask[:, :12], mask[:, 12:28] = 1, 2
    kw = dict(causal=causal, q_offset=q_off, kv_offset=kv_off)
    want = ref.attn.attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              None if mask is None else jnp.asarray(mask), **kw)
    got = attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                    None if mask is None else torch.from_numpy(mask), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_repeat_kv(ref):
    from llama_pipeline_parallel_tpu_torch.ops.attention import repeat_kv

    x = np.random.RandomState(3).randn(2, 5, 2, 8).astype(np.float32)
    np.testing.assert_array_equal(repeat_kv(torch.from_numpy(x), 3).numpy(),
                                  np.asarray(ref.attn.repeat_kv(jnp.asarray(x), 3)))


@pytest.mark.parametrize("num_chunks", [1, 4])
def test_fused_ce_values_and_grads(ref, num_chunks):
    """Loss sum, count, dh and dW against the reference's custom VJP, with
    ignored targets; fp32, sums over 64 tokens x 256 classes."""
    rng = np.random.RandomState(4)
    h = rng.randn(2, 32, 48).astype(np.float32)
    w = (0.1 * rng.randn(48, 256)).astype(np.float32)
    t = rng.randint(0, 256, size=(2, 32)).astype(np.int32)
    t[0, :5] = IGNORE_INDEX
    t[1, -3:] = IGNORE_INDEX

    def ref_loss(h_, w_):
        loss_sum, count = ref.ce.fused_ce_sum_count(h_, w_, jnp.asarray(t), num_chunks)
        return loss_sum, count

    (want_sum, want_count), want_grads = jax.value_and_grad(
        ref_loss, argnums=(0, 1), has_aux=True)(jnp.asarray(h), jnp.asarray(w))
    th, tw = torch.from_numpy(h).requires_grad_(), torch.from_numpy(w).requires_grad_()
    got_sum, got_count = fused_ce_sum_count(th, tw, torch.from_numpy(t), num_chunks)
    got_sum.backward()
    assert int(got_count) == int(want_count) == 64 - 8
    np.testing.assert_allclose(got_sum.item(), float(want_sum), rtol=1e-5)
    np.testing.assert_allclose(th.grad.numpy(), np.asarray(want_grads[0]), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(want_grads[1]), rtol=1e-4, atol=1e-6)


def test_fused_ce_matches_plain_cross_entropy():
    """The chunked op equals the unchunked CE on the materialised logits."""
    rng = np.random.RandomState(5)
    h = torch.from_numpy(rng.randn(40, 32).astype(np.float32))
    w = torch.from_numpy((0.2 * rng.randn(32, 96)).astype(np.float32))
    t = torch.from_numpy(rng.randint(0, 96, size=40).astype(np.int64))
    t[::7] = IGNORE_INDEX
    got, count = fused_ce_sum_count(h, w, t, 3)
    want = torch.nn.functional.cross_entropy(h @ w, t, ignore_index=IGNORE_INDEX,
                                             reduction="sum")
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    assert int(count) == int((t != IGNORE_INDEX).sum())
