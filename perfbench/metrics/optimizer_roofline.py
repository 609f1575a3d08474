"""AdamW's share of its roofline: 7 tensors of each parameter's dtype a
parameter (:func:`perfbench.flops.optimizer_bytes`) at the card's HBM
bandwidth / the device time a step under torch's own
``Optimizer.step#...`` range."""

from perfbench import flops

LAYER = "optimizer: torch.optim.AdamW (foreach) from default_optimizer"
UNIT = "%"
MOVES = "train_tokens_per_s"
NEEDS = {"optimizer": ("range", "Optimizer.step#")}


def read(run):
    t = run.trace
    if run.peaks is None or t is None or not t["on_device"]:
        return None
    spent = t["layers"]["optimizer"]
    if spent <= 0:
        return None
    least = flops.optimizer_bytes(run.spec) / run.peaks["hbm_bytes_per_s"]
    return 100.0 * least / spent
