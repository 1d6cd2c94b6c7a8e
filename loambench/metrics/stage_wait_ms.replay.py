"""stage_wait_ms.replay: mean host time a chunk waited for its staged feed
(the stager thread's packing and upload) at the window's chunk boundaries,
the first left out: its staging starts with the window, with nothing to
overlap."""


def read(rec):
    d = rec["spans"].durations("stage_wait")[1:]
    return 1e3 * sum(d) / len(d) if d else None
