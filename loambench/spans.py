"""The port's span marks in a device trace: the frame steps launch one
tiny kernel at each boundary (`lego_loam_torch/csrc/mark.cu`), named
`lego_span_<boundary>`. In the traced chunk's device operations, sorted by
start, each mark opens a span that runs to the start of the next mark;
`front_end` opens the front end's, `odometry` the scan-to-scan odometry's,
`mapping` the scan-to-map's, and `step_end` the time between steps, as do
the operations before the first mark. Each operation (kernels and copies,
the marks included) belongs to the span open at its start, so the layers
part the operations that `device_busy_ms_per_scan` counts."""

from __future__ import annotations

from .roofline import busy

MARKS = {"lego_span_front_end": "front_end", "lego_span_odometry": "odometry", "lego_span_mapping": "mapping",
         "lego_span_step_end": "between_steps"}
LAYERS = ("front_end", "odometry", "mapping", "between_steps")


def mark_of(name: str):
    """The layer a device operation's name opens, or None for any other."""
    return MARKS.get(name.split("(")[0].strip())


def layer_ops(ops) -> dict | None:
    """{layer: [(start, end), ...]} of the (name, start, end) device
    operations; None without a mark among them."""
    out = {k: [] for k in LAYERS}
    layer, seen = "between_steps", False
    for name, s, e in sorted(ops, key=lambda op: op[1]):
        opened = mark_of(name)
        if opened is not None:
            layer, seen = opened, True
        out[layer].append((s, e))
    return out if seen else None


def layer_ms_per_scan(rec, layer: str):
    """Busy time of `layer`'s operations (the union of their intervals) in
    the traced chunk, per scan (ms); None without a trace or a mark."""
    tr = rec.get("trace")
    by_layer = layer_ops(tr.ops) if tr is not None and tr.ops else None
    if by_layer is None:
        return None
    return 1e3 * busy(by_layer[layer]) / rec["trace_scans"]
