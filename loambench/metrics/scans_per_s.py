"""scans_per_s: every scan of the window over the window's time (host
clock; the window ends with a device synchronize)."""


def read(rec):
    return rec["scans"] / rec["window_s"] if rec.get("window_s") else None
