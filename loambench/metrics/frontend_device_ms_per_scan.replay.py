"""frontend_device_ms_per_scan.replay: device busy time of the front end in
the traced chunk, per scan: the operations from each `front_end` mark of
the port to its next mark (the chunk's prepass, and each front step up to
its odometry mark; `loambench/spans.py`)."""

from loambench.spans import layer_ms_per_scan


def read(rec):
    return layer_ms_per_scan(rec, "front_end")
