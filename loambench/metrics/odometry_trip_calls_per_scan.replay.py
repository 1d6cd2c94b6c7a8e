"""odometry_trip_calls_per_scan.replay: launches of the scan-to-scan
odometry's trip kernel (`odo_trip@odometry_*` of the port's launch counts)
over the window, per scan. A port without the kernel counts none: nothing
to read."""


def read(rec):
    n = sum(v for k, v in rec["sites"].items() if k.startswith("odo_trip@odometry_"))
    return n / rec["scans"] if n and rec["scans"] else None
