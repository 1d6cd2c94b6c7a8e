"""setup_s: process start to the first timed scan (host clock)."""


def read(rec):
    return rec["setup_s"]
