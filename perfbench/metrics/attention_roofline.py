"""Attention's share of its roofline: the least time of the cell's
causal attention, forward and backward, every layer
(:func:`perfbench.flops.attention_work` at the card's peaks) / the
device time a step of the work attributed to
``ops/flash_attention.py`` (the flash forward kernel and the backward)."""

from perfbench import flops

LAYER = "attention: ops/flash_attention.py"
UNIT = "%"
MOVES = "train_tokens_per_s"
NEEDS = {"attention": ("calls", ["horovod_tpu_torch.ops.flash_attention:flash_attention"])}


def read(run):
    t = run.trace
    if run.peaks is None or t is None or not t["on_device"]:
        return None
    spent = t["layers"]["attention"]
    if spent <= 0:
        return None
    work = flops.attention_work(run.spec, run.traffic.rows_per_gpu,
                                run.traffic.seq)
    least = flops.least_seconds(work, run.peaks["bf16_flops"],
                                run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / spent
