"""enqueue_ms_per_scan.replay: host time inside `process_chunk` over the
window's untraced chunks, per scan."""


def read(rec):
    d = rec["spans"].durations("process_chunk")
    return 1e3 * sum(d) / (len(d) * rec["chunk"]) if d else None
