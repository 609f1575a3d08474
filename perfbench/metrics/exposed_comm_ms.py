"""The gradient exchange the backward does not hide: CUDA events on the
training stream from the end of ``backward()`` to the end of the hook
optimizer's ``synchronize()``, summed over the untraced window's steps /
the steps, the mean over ranks."""

LAYER = "eager gradient plane: torch/optimizer.py hooks, api.py, runtime.py, native core, ops/nccl_exec.py"
UNIT = "ms"
MOVES = "train_tokens_per_s"
NEEDS = {}


def read(run):
    per_rank = [x for x in run.exposed_ms if x is not None]
    if not per_rank or len(per_rank) != len(run.exposed_ms):
        return None
    return sum(per_rank) / len(per_rank)
