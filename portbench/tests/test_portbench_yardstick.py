"""The frozen yardstick against hand-worked values."""
import math

import pytest
import torch

import tiny
from portbench import spec as spec_mod
from portbench.yardstick import compare, cost, devtrace, flops, peaks


def meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_peaks_and_bound():
    assert (peaks.PEAK_BF16_FLOPS, peaks.HBM_BYTES_PER_S) == (989e12, 3.35e12)
    assert peaks.bound_seconds(989e12, 1.0) == pytest.approx(1.0)
    assert peaks.bound_seconds(1.0, 3.35e12) == pytest.approx(1.0)


def test_attended_pairs():
    assert cost.attended_pairs(4, 4, True) == 10      # 1 + 2 + 3 + 4
    assert cost.attended_pairs(2, 4, True) == 7       # 3 + 4
    assert cost.attended_pairs(3, 5, False) == 15


def test_flash_work():
    q = meta((1, 4, 2, 8), torch.bfloat16)            # 64 elements, 128 B
    f, b = cost.flash_work(q, q, q, causal=True)
    assert f == 4 * 1 * 2 * 8 * 10 and b == 2 * 128 + 128 + 128


def test_latent_topk_work():
    f, b = cost.latent_topk_work(
        meta((2, 8), torch.float32), meta((2, 64, 16), torch.bfloat16), None,
        n_critical=4, selectable_rows=100)
    # 2·100·8; q 64 B + 100 rows × 8 cols × 2 B + positions and bases 16 B
    # + indices and validity 2·4·5 B
    assert f == 1600 and b == 64 + 1600 + 16 + 40


def test_recon_work():
    f, b = cost.recon_work(
        meta((2, 4, 32), torch.bfloat16), meta((2, 64, 16), torch.bfloat16),
        None, meta((2, 64, 64), torch.int8), meta((2, 64, 2), torch.bfloat16),
        meta((2, 64, 2), torch.bfloat16), meta((64, 16), torch.bfloat16),
        meta((2, 4), torch.int32), n_kv=2, valid_rows=6)
    # per valid row: latent 32 B + codes 64 B + scale and zero 8 B = 104
    assert f == 2 * 6 * 64 * 16 + 4 * 6 * 4 * 32
    assert b == 512 + 6 * 104 + 2048 + 40 + 8 + 2 * 4 * 34 * 4


def test_decode_step_flops():
    s = spec_mod.spec_from_dict(tiny.CONFIG)
    per_layer = 128 * 128 + 2 * 128 * 64 + 128 * 128 + 3 * 128 * 256
    gemm = 2 * (5 * per_layer + 128 * 512)
    # full layers 0, 1, 4 attend 101 tokens; SALS layers 2, 3 attend
    # 4 sink + 8 recent + 16 of the 89 selectable
    att = 3 * 101 + 2 * (4 + 8 + 16)
    assert flops.decode_step_flops(s, [100]) == gemm + 4 * 4 * 32 * att
    assert flops.decode_step_flops(s, [100, 100]) == 2 * (gemm + 4 * 4 * 32
                                                          * att)


def test_gaps():
    lg = torch.tensor([[1.0, 3.0, 2.0], [0.0, -1.0, 5.0]])
    assert compare.token_gaps(lg, torch.tensor([2, 2])).tolist() == [1.0, 0.0]
    assert compare.widest_gap([lg], [torch.tensor([0, 1])]) == 6.0
    low = torch.tensor([[0.0, 0.0, 9.0], [9.0, 0.0, 0.0]])
    assert compare.control_gap([lg], [low]) == 5.0


def test_device_trace_busy_and_gaps():
    ev = [{"ph": "X", "cat": "user_annotation", "name": devtrace.WINDOW,
           "ts": 1000.0, "dur": 100.0},
          {"ph": "X", "cat": "kernel", "name": "k1", "ts": 1010.0,
           "dur": 20.0},
          {"ph": "X", "cat": "kernel", "name": "k2", "ts": 1020.0,
           "dur": 20.0},
          {"ph": "X", "cat": "gpu_memcpy", "name": "m", "ts": 1060.0,
           "dur": 10.0},
          {"ph": "X", "cat": "kernel", "name": "late", "ts": 2000.0,
           "dur": 5.0}]
    t0 = 5.0          # perf_counter at the window's start
    t = devtrace.DeviceTrace.from_events(
        ev, t0, [("a", t0 + 30e-6, t0 + 65e-6)])
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(40e-6)
    assert t.seconds_matching("^k") == pytest.approx(40e-6)
    assert [n for n, _ in t.top_ops()] == ["k1", "k2", "m"]
    gaps = dict(t.idle_gaps())
    assert gaps["host"] == pytest.approx(40e-6)    # [1000, 1010), [1070, 1100)
    assert gaps["a"] == pytest.approx(20e-6)       # [1040, 1060)
    assert math.isclose(sum(gaps.values()), t.window_s - t.busy_s)
