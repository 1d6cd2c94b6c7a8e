"""The yardstick's arithmetic on hand-made numbers: interval unions, K1's
bytes, the check's per-frame gaps and their statistics, and the trace's
breakdown."""

import math

import numpy as np
import pytest
import torch

from loambench import check, roofline, trace
from loambench.harness import Spans, metric_reader


def test_union_busy_and_gaps():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (6.0, 7.0)]
    assert roofline.union(iv) == [(0.0, 2.0), (3.0, 4.0), (6.0, 7.0)]
    assert roofline.busy(iv) == 4.0
    assert roofline.gaps(iv) == [(2.0, 3.0), (4.0, 6.0)]


def test_k1_bytes_and_roofline_reader():
    assert roofline.k1_bytes(16, 1800, 32) == 9 * 16 * 1800 * 32

    class T:
        ops = [("cc_label_prop_kernel", 0.0, 1e-3), ("knn_top5_kernel", 1e-3, 3e-3), ("Memcpy HtoD", 3e-3, 4e-3)]
        marks = []

    rec = {"trace": T, "rows": 16, "cols": 1800, "chunk": 32, "trace_scans": 32, "spans": Spans(), "sites": {},
           "scans": 32}
    bound_s = 9 * 16 * 1800 * 32 / 3.35e12
    assert metric_reader("k1_roofline.replay")(rec) == pytest.approx(100 * bound_s / 1e-3)
    assert metric_reader("k2_device_ms_per_scan.replay")(rec) == pytest.approx(2.0 / 32)
    assert metric_reader("kernels_per_scan.replay")(rec) == pytest.approx(2 / 32)
    assert metric_reader("device_busy_ms_per_scan.replay")(rec) == pytest.approx(4.0 / 32)
    T.ops = [("other", 0.0, 1.0)]
    assert metric_reader("k1_roofline.replay")(rec) is None  # nothing to read: left out, never 0


def test_frame_gaps_and_their_statistics():
    n = 10
    t = np.stack([np.arange(n) * 0.12, np.zeros(n), np.zeros(n)], 1)
    rpy = np.zeros((n, 3))
    port = {"map_t": t.copy(), "map_rpy": rpy.copy(), "odom_t": t.copy()}
    ref = {"map_t": t.copy(), "map_rpy": rpy.copy(), "odom_t": t.copy()}
    port["map_t"][3, 1] += 0.01  # one frame's map pose
    port["map_rpy"][4, 2] = np.radians(0.5)
    port["odom_t"][6:, 2] += 0.002
    rows = {"kf_corner": torch.zeros((2, 6)), "kf_corner_mask": torch.ones((2, 2), dtype=torch.bool),
            "kf_surf": torch.zeros((2, 6)), "kf_surf_mask": torch.ones((2, 2), dtype=torch.bool)}
    moved = dict(rows, kf_surf=torch.tensor([[0.0] * 6, [0.01, 0, 0, 0, 0, 0]]))
    gaps = check.frame_gaps(port, ref, moved, rows)
    assert gaps["map"] == pytest.approx([0] * 3 + [0.01] + [0] * 6)
    assert gaps["rot"] == pytest.approx([0] * 4 + [0.5] + [0] * 5)
    assert gaps["odom"] == pytest.approx([0] * 6 + [0.002] * 4)
    assert gaps["cloud"] == pytest.approx([0.0, 50.0])
    got = check.readings_of(gaps)
    assert got["map_pos_gap_max_m"] == pytest.approx(0.01) and got["map_pos_gap_p80_m"] == 0.0
    assert got["odom_pos_gap_median_m"] == 0.0 and got["kf_cloud_diff_p80_pct"] == pytest.approx(40.0)
    quarter = check.readings_of({"map": [0.0] * 30 + [0.05] * 10})  # a fault on a quarter of the frames
    assert quarter["map_pos_gap_p80_m"] == pytest.approx(0.05) and quarter["map_pos_gap_median_m"] == 0.0
    port["map_t"][2, 0] = np.nan
    assert check.readings_of(check.frame_gaps(port, ref, rows, rows))["map_pos_gap_p80_m"] == math.inf


def test_rates_and_spans():
    s = Spans()
    s.spans = {"stage_wait": [(0.0, 0.3), (1.0, 1.002), (2.0, 2.004)], "process_chunk": [(0.0, 0.32), (1.0, 1.64)]}
    rec = {"scans": 64, "window_s": 3.2, "spans": s, "chunk": 32,
           "sites": {"knn_top5@odometry_corner": 640, "knn_top5@odometry_surf": 640, "knn_top5@mapping_corner": 64,
                     "knn_top5@mapping_surf": 64, "knn_top5@loop_icp": 20}}
    assert metric_reader("scans_per_s")(rec) == 20.0
    assert metric_reader("stage_wait_ms.replay")(rec) == pytest.approx(3.0)
    assert metric_reader("enqueue_ms_per_scan.replay")(rec) == pytest.approx(1e3 * 0.96 / 64)
    assert metric_reader("odometry_k2_calls_per_scan.replay")(rec) == 20.0
    assert metric_reader("mapping_k2_calls_per_scan.replay")(rec) == 2.0


def test_breakdown_labels_gaps_by_the_open_span():
    ops = [("a", 0.0, 1.0), ("b", 1.5, 2.0), ("a", 4.0, 5.0)]
    marks = [("process_chunk", 0.0, 1.8), ("stage_wait", 1.9, 3.9)]
    out = trace.summary(ops, marks)
    assert out["device_ops"] == [["a", 2.0], ["b", 0.5]]
    assert out["idle_gaps"] == [["stage_wait", 2.0], ["process_chunk", 0.5]]
    assert trace.summary(ops, [])["idle_gaps"] == [["none", 2.0], ["none", 0.5]]
    assert trace.is_kernel("knn_top5_kernel") and not trace.is_kernel("Memcpy DtoD (Device -> Device)")
    assert math.isclose(roofline.busy([(s, e) for _, s, e in ops]), 2.5)
