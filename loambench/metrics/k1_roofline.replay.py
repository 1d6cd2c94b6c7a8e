"""k1_roofline.replay: K1's byte bound (`roofline.k1_bytes` over the
data sheet's 3.35 TB/s) over `cc_label_prop`'s device time in the traced
chunk. Each launch labels the whole chunk."""

from loambench.roofline import HBM_BYTES_PER_S, k1_bytes


def read(rec):
    tr = rec.get("trace")
    k1 = [(s, e) for name, s, e in (tr.ops if tr else ()) if "cc_label_prop" in name]
    if not k1:
        return None
    bound_s = k1_bytes(rec["rows"], rec["cols"], rec["chunk"] * len(k1)) / HBM_BYTES_PER_S
    return 100.0 * bound_s / sum(e - s for s, e in k1)
