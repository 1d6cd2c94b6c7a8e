"""k2_device_ms_per_scan.replay: device time of K2 (`knn_top5` kernels) in
the traced chunk, per scan."""


def read(rec):
    tr = rec.get("trace")
    k2 = [e - s for name, s, e in (tr.ops if tr else ()) if "knn_top5" in name]
    return 1e3 * sum(k2) / rec["trace_scans"] if k2 else None
