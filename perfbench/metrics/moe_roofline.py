"""The MoE layer's share of its roofline: the least time of the useful
expert work (every kept claim's three products and the router, forward
and backward, or the expert weights read and their gradients written;
:func:`perfbench.flops.moe_work`) / the device time a step of the work
attributed to ``models/moe.py`` (routing, dispatch, the expert FFN,
combine). Slots left empty at the capacity are not work."""

from perfbench import flops

LAYER = "MoE layer: models/moe.py"
UNIT = "%"
MOVES = "train_tokens_per_s"
NEEDS = {"moe": ("calls", ["horovod_tpu_torch.models.moe:moe_ffn"])}


def read(run):
    t = run.trace
    if (run.peaks is None or t is None or not t["on_device"]
            or not run.spec.n_experts):
        return None
    spent = t["layers"]["moe"]
    if spent <= 0:
        return None
    work = flops.moe_work(run.spec, run.traffic.rows_per_gpu, run.traffic.seq)
    least = flops.least_seconds(work, run.peaks["bf16_flops"],
                                run.peaks["hbm_bytes_per_s"])
    return 100.0 * least / spent
