"""between_steps_device_ms_per_scan.replay: device busy time between the
port's frame steps in the traced chunk, per scan: the operations from each
`step_end` mark to the next mark, and those before the first mark (graph
input and output copies, the draws, loop closure; `loambench/spans.py`)."""

from loambench.spans import layer_ms_per_scan


def read(rec):
    return layer_ms_per_scan(rec, "between_steps")
