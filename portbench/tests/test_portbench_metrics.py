"""The metric arithmetic on a synthetic trace and synthetic readings."""

import math
from types import SimpleNamespace

import pytest

from portbench import counts, readers, trace


def _x(name, ts, dur, cat):
    return {"ph": "X", "name": name, "ts": ts, "dur": dur, "cat": cat}


def _trace():
    # a 100 us window: kernels busy 10-30 (two overlapping), 50-60, a copy
    # 70-80; the host in a runtime call over 0-10, in an aten op over 30-50
    # and in no traced op over 60-70 and 80-100
    return trace.Trace([
        _x(trace.WINDOW, 0.0, 100.0, "user_annotation"),
        _x("void (anonymous namespace)::bb::fwd_kernel<1>(float const*)", 10.0, 15.0, "kernel"),
        _x("void (anonymous namespace)::bb::bwd_kernel<1>(float const*)", 20.0, 10.0, "kernel"),
        _x("void (anonymous namespace)::fwd_kernel<(anonymous namespace)::Dr, 1>(float*)",
           50.0, 10.0, "kernel"),
        _x("Memcpy DtoH (Device -> Pageable)", 70.0, 10.0, "gpu_memcpy"),
        _x("aten::mul", 30.0, 20.0, "cpu_op"),
        _x("cudaLaunchKernel", 0.0, 10.0, "cuda_runtime"),
        _x("outside the window", 200.0, 10.0, "kernel"),
    ])


def test_busy_time_is_the_union_of_device_operations():
    tr = _trace()
    assert tr.window_s == pytest.approx(100e-6)
    assert tr.busy_s == pytest.approx(40e-6)
    assert len(tr.kernels()) == 3


def test_idle_gaps_are_named_by_the_host_activity_covering_them():
    gaps = dict(_trace().breakdown()["idle_gaps"])
    assert gaps["cudaLaunchKernel"] == pytest.approx(10e-6)
    assert gaps["aten::mul"] == pytest.approx(20e-6)
    assert gaps["host: no traced op"] == pytest.approx(30e-6)


def test_kernel_names_match_the_hand_written_kernels_only():
    tr = _trace()
    for kernel, calls in (("blackbox_fwd", 1), ("blackbox_bwd", 1), ("dr_fwd", 1)):
        assert tr.kernel_seconds(readers.KERNELS[kernel])[0] == calls
    assert not readers.KERNELS["dr_fwd"]("void (anonymous namespace)::prec_fwd_kernel<"
                                         "(anonymous namespace)::Dr, 1>(float*)")


def test_black_box_counts_are_the_kernel_table_s():
    # PERF.md's kernel table: 6,940 operations a pullback row, 22.2 GFLOP a
    # forward call at 36,000 rows, 12.9 GFLOP a backward call at 7,200
    nets = counts.bb_nets(6, 21, 25, 20)
    assert counts.bb_flops(nets)[1] == 6940
    fwd, bwd = counts.bb_step_flops(nets, 10)
    assert fwd * 85 * 36000 == pytest.approx(22.2e9, rel=2e-3)
    assert bwd * 85 * 7200 == pytest.approx(12.9e9, rel=4e-3)


def _run(mode):
    shapes = dict(R=1000, T=86, S=10, n_const=21, n_w=4 * 1760, nets=counts.bb_nets(6, 21, 25, 20))
    return SimpleNamespace(mode=mode, trace=_trace(), trace_units=2, shapes=shapes,
                           window_s=5e-4, units=10, rows_per_unit=500)


def test_roofline_is_the_bound_over_the_device_time():
    run = _run("train")
    n_bytes, n_flops = counts.kernel_cost("blackbox_bwd", run.shapes)
    want = 100.0 * counts.bound_s(n_bytes, n_flops) / 10e-6
    assert readers.roofline(run, "blackbox_bwd", "train") == pytest.approx(want)
    assert readers.roofline(run, "blackbox_bwd", "eval") is None
    run.trace = None
    assert readers.roofline(run, "blackbox_bwd", "train") is None


def test_shares_launches_and_rates():
    run = _run("eval")
    # 40 us busy in the trace's 100 us window
    assert readers.idle_share(run, "eval") == pytest.approx(60.0)
    assert readers.launches_per_unit(run, "eval") == pytest.approx(1.5)
    assert readers.rate(run, "eval") == pytest.approx(10 * 500 / 5e-4)
    assert readers.rate(run, "train") is None


def test_percentile_interpolates_like_numpy():
    assert counts.percentile([1.0, 2.0, 3.0, 4.0], 95) == pytest.approx(3.85)
    assert math.isnan(counts.percentile([], 95))
