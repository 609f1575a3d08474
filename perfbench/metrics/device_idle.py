"""The share of the traced span in which no device activity ran:
1 - the union of the kernels' intervals / the span's length, on rank 0."""

LAYER = "device"
UNIT = "%"
MOVES = "train_tokens_per_s"
NEEDS = {}


def read(run):
    t = run.trace
    if t is None or not t["on_device"] or t["span_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["span_s"])
