"""The whole step's share of the card's bf16 dense peak: model FLOPs a
token (:func:`perfbench.flops.model_flops_per_token`: 6 x the active
matrix parameters, lm_head counted and the embedding table not, plus
causal attention) x the untraced window's tokens/s a GPU / the peak."""

from perfbench import flops

LAYER = "train step: models/transformer.py::make_train_step, lm_loss"
UNIT = "%"
MOVES = "train_tokens_per_s"
NEEDS = {}


def read(run):
    if run.peaks is None:
        return None
    per_token = flops.model_flops_per_token(run.spec, run.traffic.seq)
    return 100.0 * per_token * run.tokens_per_s / run.peaks["bf16_flops"]
