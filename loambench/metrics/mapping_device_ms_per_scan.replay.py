"""mapping_device_ms_per_scan.replay: device busy time of the scan-to-map
step in the traced chunk, per scan: the operations from each `mapping`
mark of the port to its next mark (`loambench/spans.py`)."""

from loambench.spans import layer_ms_per_scan


def read(rec):
    return layer_ms_per_scan(rec, "mapping")
