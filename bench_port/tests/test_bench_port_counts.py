"""The yardstick's counts against numbers worked by hand for each cell's shapes,
and the readers' arithmetic on a made-up trace."""

import numpy as np
import pytest

from bench_port import cells, counts, devtrace
from bench_port.harness import Reading

MISTRAL = cells.load("mistral7b-stage.full-4k").config
DEEPSEEK = cells.load("deepseek7b-last.full-4k").config


def full_rows(rows, seq, micro):
    return counts.StepShape.of(np.ones((rows, seq), np.int64),
                               np.zeros((rows, seq), np.int64), micro)


def test_matmul_parameters():
    # per layer q 4096^2 + k, v 4096 * 1024 + o 4096^2 + 3 * 4096 * 14336; head 4096 * 32000
    assert counts.matmul_params(MISTRAL) == 8 * 218_103_808 + 131_072_000 == 1_875_902_464
    # MHA: 4 * 4096^2 + 3 * 4096 * 11008; head 4096 * 102400
    assert counts.matmul_params(DEEPSEEK) == 6 * 202_375_168 + 419_430_400 == 1_633_681_408


def test_model_flops_of_each_traffic():
    full = full_rows(8, 4096, 4)
    assert full.tokens == 32768 and full.targets == [8190] * 4
    pairs = 8 * 4096 * 4097 // 2                                # 67,125,248
    assert counts.model_flops(MISTRAL, full) == pytest.approx(
        6 * 1_875_902_464 * 32768 + 12 * 8 * 4096 * pairs)      # 395.2 TFLOP
    assert counts.model_flops(MISTRAL, full) == pytest.approx(3.9521215e14, rel=1e-7)
    assert counts.model_flops(DEEPSEEK, full) == pytest.approx(
        6 * 1_633_681_408 * 32768 + 12 * 6 * 4096 * pairs)      # 341.0 TFLOP
    long = full_rows(1, 32768, 1)
    assert counts.model_flops(MISTRAL, long) == pytest.approx(
        6 * 1_875_902_464 * 32768 + 12 * 8 * 4096 * (32768 * 32769 // 2))  # 579.9 TFLOP
    assert counts.model_flops(MISTRAL, long) == pytest.approx(5.7993011e14, rel=1e-7)


def test_segments_count_pairs_inside_documents_only():
    seg = np.array([[1, 1, 1, 2, 2, 0, 0, 0], [1, 1, 1, 1, 1, 1, 2, 2]])
    labels = np.array([[-100, -100, 5, -100, 6, -100, -100, -100],
                       [-100, 4, 4, 4, 4, 4, -100, 3]])
    shape = counts.StepShape.of(seg, labels, 2)
    assert shape.docs == [[[3, 2]], [[6, 2]]]
    assert shape.tokens == 13
    assert shape.targets == [2, 6]   # kept targets after the shift, per microbatch
    assert counts.pairs([3, 2]) == 6 + 3


def test_least_times_at_the_full_4k_step():
    shape = full_rows(8, 4096, 4)
    # a microbatch: 2 rows, 16,781,312 causal pairs; forward 2 products and
    # backward 4 of 2 * 128 per pair and q head; operation-bound
    mb_pairs = 2 * 4096 * 4097 // 2
    fwd = 2 * 2 * 128 * 32 * mb_pairs / 989e12
    assert counts.flash_least_s(MISTRAL, shape, False) == pytest.approx(8 * 4 * 3 * fwd)
    assert counts.flash_least_s(MISTRAL, shape, False) == pytest.approx(0.026686, rel=1e-4)
    # head: 8,190 kept targets a microbatch, 2 n d V forward + 4 n d V backward
    head = 8190 * 4096 * 32000 * 6 / 989e12
    assert counts.ce_least_s(MISTRAL, shape) == pytest.approx(4 * head)
    assert counts.ce_least_s(DEEPSEEK, shape) == pytest.approx(4 * head * 102400 / 32000)
    # prologue: 3 products of 2 * 8192 * 4096 * (32 + 2 * 8) * 128 a layer and microbatch
    pro = 3 * 2 * 8192 * 4096 * 6144 / 989e12
    assert counts.prologue_least_s(MISTRAL, shape) == pytest.approx(8 * 4 * pro)
    assert counts.prologue_least_s(DEEPSEEK, shape) == pytest.approx(
        6 * 4 * pro * 12288 / 6144)


def test_a_tiny_product_is_bound_by_bytes():
    model = dict(MISTRAL, num_hidden_layers=1)
    shape = full_rows(1, 8, 1)
    q, k = 8 * 32 * 128 * 2, 8 * 8 * 128 * 2
    fwd_bytes = q + 2 * k + q + 8 * 32 * 4
    bwd_bytes = 3 * q + 2 * k + 8 * 32 * 4 + q + 2 * k
    assert counts.flash_least_s(model, shape, False) == pytest.approx(
        (fwd_bytes + bwd_bytes) / 3.35e12)


def _reading(kernels, window_s=2.0, steps=2):
    cell = cells.load("mistral7b-stage.full-4k")
    shape = full_rows(8, 4096, 4)
    trace = devtrace.DeviceTrace(kernels, busy_s=1.5, gaps=[])
    return Reading(cell=cell, setup_s=1.0, window_s=window_s, steps=steps, tokens=2 * 32768,
                   peak_bytes=2**33, data_wait_s=[0.001, 0.003], shapes=[shape] * steps,
                   pad_positions=0, row_positions=2 * 32768, trace=trace)


def test_readers_on_a_made_up_trace():
    shape = full_rows(8, 4096, 4)
    flash = counts.flash_least_s(MISTRAL, shape, False)
    ks = [devtrace.Kernel("bwd_dkv_tc_kernel", 0, int(4 * flash * 1e9), False),
          devtrace.Kernel("nvjet_tst_256x128", 0, 300_000_000, False),
          devtrace.Kernel("void at::native::vectorized_elementwise_kernel", 0, 100_000_000, True),
          devtrace.Kernel("void at::native::vectorized_elementwise_kernel", 0, 60_000_000, False),
          devtrace.Kernel("Memcpy HtoD (Pageable -> Device)", 0, 20_000_000, False)]
    r = _reading(ks)
    read = {m: cells.reader(m)(r) for m in ("flash_roofline", "gemm_ms", "eager_ms",
                                            "optimizer_ms", "device_idle", "data_wait_ms",
                                            "tokens_per_s", "peak_mem_gib", "pad_share",
                                            "ce_roofline", "mfu")}
    assert read["flash_roofline"] == pytest.approx(2 * 100 / 4)   # two steps' work in 4x
    assert read["gemm_ms"] == pytest.approx(150.0)
    assert read["eager_ms"] == pytest.approx(40.0)
    assert read["optimizer_ms"] == pytest.approx(50.0)
    assert read["device_idle"] == pytest.approx(25.0)
    assert read["data_wait_ms"] == pytest.approx(2.0)
    assert read["tokens_per_s"] == pytest.approx(32768.0)
    assert read["peak_mem_gib"] == pytest.approx(8.0)
    assert read["pad_share"] is None and read["ce_roofline"] is None
    assert read["mfu"] == pytest.approx(100 * 2 * 3.9521215e14 / (2.0 * 989e12), rel=1e-6)


def test_families_are_the_profile_tools():
    import importlib.util
    import os

    path = os.path.join(cells.ROOT, "tools", "torch_step_profile.py")
    spec = importlib.util.spec_from_file_location("torch_step_profile", path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert counts.FAMILIES == tool.FAMILIES
