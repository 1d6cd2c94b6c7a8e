"""device_busy_ms_per_scan.replay: the union of device operations'
intervals in the traced chunk, per scan: the device's own time for a
scan, which the profiler's per-kernel overhead does not stretch."""

from loambench.roofline import busy


def read(rec):
    tr = rec.get("trace")
    if tr is None or not tr.ops:
        return None
    return 1e3 * busy([(s, e) for _, s, e in tr.ops]) / rec["trace_scans"]
