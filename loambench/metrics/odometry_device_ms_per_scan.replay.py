"""odometry_device_ms_per_scan.replay: device busy time of the scan-to-scan
odometry in the traced chunk, per scan: the operations from each
`odometry` mark of the port to its next mark (the two-step GN, the fusion
and the deskew; `loambench/spans.py`)."""

from loambench.spans import layer_ms_per_scan


def read(rec):
    return layer_ms_per_scan(rec, "odometry")
