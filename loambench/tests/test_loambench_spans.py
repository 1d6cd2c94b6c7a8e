"""The per-layer readers of the port's span marks (`loambench/spans.py`) on
a hand-built trace: each layer's busy time, their sum against the device's
busy time, and nothing to read where the trace has no mark."""

import pytest

from loambench import spans
from loambench.harness import Spans, metric_reader

LAYER_METRICS = {
    "front_end": "frontend_device_ms_per_scan.replay",
    "odometry": "odometry_device_ms_per_scan.replay",
    "mapping": "mapping_device_ms_per_scan.replay",
    "between_steps": "between_steps_device_ms_per_scan.replay",
}

# One chunk of 2 scans, in ms: a copy before the first mark, the prepass,
# a front step of each scan and one map step, with copies between the
# steps. Two of the odometry's kernels overlap (their union counts once).
OPS_MS = [
    ("Memcpy HtoD (Pageable -> Device)", 0.0, 1.0),  # before the first mark: between steps
    ("lego_span_front_end", 2.0, 2.5),  # prepass
    ("cc_label_prop_kernel", 3.0, 5.0),
    ("lego_span_step_end", 5.5, 6.0),
    ("Memcpy DtoD (Device -> Device)", 6.5, 7.0),
    ("lego_span_front_end(long long*, int)", 8.0, 8.5),  # front step, scan 0
    ("segment_kernel", 9.0, 10.0),
    ("lego_span_odometry", 10.5, 11.0),
    ("knn_top5_kernel", 11.0, 14.0),
    ("gn_kernel", 13.0, 15.0),
    ("lego_span_step_end", 15.0, 15.5),
    ("lego_span_mapping", 16.0, 16.5),  # map step, scan 0
    ("knn_top5_kernel", 17.0, 19.0),
    ("lego_span_step_end", 19.0, 19.5),
    ("lego_span_front_end", 20.0, 20.5),  # front step, scan 1
    ("lego_span_odometry", 21.0, 21.5),
    ("gn_kernel", 22.0, 24.0),
    ("lego_span_step_end", 24.5, 25.0),
    ("elementwise_kernel", 26.0, 27.0),  # the loop probe after the chunk
]
EXPECTED_MS = {  # over the chunk
    "front_end": 0.5 + 2.0 + 0.5 + 1.0 + 0.5,
    "odometry": 0.5 + 4.0 + 0.5 + 2.0,
    "mapping": 0.5 + 2.0,
    "between_steps": 1.0 + 0.5 + 0.5 + 0.5 + 0.5 + 0.5 + 1.0,
}


def _rec(ops_ms):
    class Trace:
        ops = [(n, 1e-3 * s, 1e-3 * e) for n, s, e in reversed(ops_ms)]  # unsorted: the readers sort
        marks = []

    return {"trace": Trace, "trace_scans": 2, "spans": Spans(), "sites": {}, "scans": 2}


@pytest.mark.parametrize("layer", spans.LAYERS)
def test_each_layer_reads_its_spans(layer):
    got = metric_reader(LAYER_METRICS[layer])(_rec(OPS_MS))
    assert got == pytest.approx(EXPECTED_MS[layer] / 2)


def test_layers_part_the_device_busy_time():
    rec = _rec(OPS_MS)
    total = sum(metric_reader(m)(rec) for m in LAYER_METRICS.values())
    assert total == pytest.approx(metric_reader("device_busy_ms_per_scan.replay")(rec))
    assert sum(EXPECTED_MS.values()) / 2 == pytest.approx(total)


def test_no_mark_reads_nothing():
    plain = [op for op in OPS_MS if spans.mark_of(op[0]) is None]
    rec = _rec(plain)
    assert metric_reader("device_busy_ms_per_scan.replay")(rec) > 0
    for m in LAYER_METRICS.values():
        assert metric_reader(m)(rec) is None
        assert metric_reader(m)({"trace": None, "trace_scans": 2}) is None
