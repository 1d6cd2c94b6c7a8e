"""kernels_per_scan.replay: device kernels (copies and sets left out) in
the traced chunk, per scan."""

from loambench.trace import is_kernel


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr.ops:
        return None
    return sum(1 for name, _, _ in tr.ops if is_kernel(name)) / rec["trace_scans"]
