"""The roofline floors on hand-worked shapes."""

from __future__ import annotations

import pytest

from wtbench import readers, roofline


def test_k1_floor_by_hand():
    # 1,000 rays × (44 + 8) B + 81,932 triangles × 36 B
    assert roofline.floor_bytes("k1", 1000, 81932) == 52000 + 2949552


def test_k2_and_k3_floors_by_hand():
    assert roofline.floor_bytes("k2", 10, 12) == 10 * 45 + 12 * 36
    assert roofline.floor_bytes("k3", 262144, 81932) == \
        262144 * 188 + 81932 * 36


def test_floor_seconds_sums_calls():
    calls = [(100, 10), (50, 10)]
    want = (100 * 52 + 10 * 36 + 50 * 52 + 10 * 36) / 3.35e12
    assert roofline.floor_seconds("k1", calls) == pytest.approx(want)


def test_share_reads_floor_over_kernel_time():
    floor = roofline.floor_seconds("k3", [(1000, 2000)])
    ctx = dict(calls={"k3": [(1000, 2000)]},
               trace=dict(kernels={"void cone_minz_kernel<1>(...)":
                                   [3, 4 * floor]}, launches=3))
    assert readers.roofline_pct(ctx, "k3") == pytest.approx(25.0)


def test_no_calls_or_no_time_reads_nothing():
    assert readers.roofline_pct(dict(calls={"k1": []},
                                     trace=dict(kernels={})), "k1") is None
    assert readers.roofline_pct(
        dict(calls={"k1": [(1, 1)]}, trace=dict(kernels={})), "k1") is None
    assert readers.idle_pct(dict(trace=dict(busy_s=0.0, window_s=1.0))) \
        is None
