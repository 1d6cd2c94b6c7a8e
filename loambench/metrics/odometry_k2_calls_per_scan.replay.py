"""odometry_k2_calls_per_scan.replay: K2 launches at the scan-to-scan
sites (`knn_top5@odometry_*` of the port's launch counts) over the window,
per scan."""


def read(rec):
    n = sum(v for k, v in rec["sites"].items() if k.startswith("knn_top5@odometry_"))
    return n / rec["scans"] if rec["scans"] else None
