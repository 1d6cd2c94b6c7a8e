"""mapping_k2_calls_per_scan.replay: K2 launches at the scan-to-map sites
(`knn_top5@mapping_*` of the port's launch counts) over the window, per
scan."""


def read(rec):
    n = sum(v for k, v in rec["sites"].items() if k.startswith("knn_top5@mapping_"))
    return n / rec["scans"] if rec["scans"] else None
