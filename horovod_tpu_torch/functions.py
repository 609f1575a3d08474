"""Bootstrap and checkpoint helpers on picklable objects, the
counterpart of :mod:`horovod_tpu.functions`: ``torch.distributed``'s
object collectives over a process group (``group=None`` is the world).
"""

from __future__ import annotations

from typing import Any, List

import torch.distributed as dist


def broadcast_object(obj: Any, root_rank: int = 0, group=None) -> Any:
    """Broadcast a picklable object from ``root_rank`` (a rank of
    ``group``); every rank returns it."""
    box = [obj if dist.get_rank(group) == root_rank else None]
    dist.broadcast_object_list(
        box, src=root_rank if group is None
        else dist.get_global_rank(group, root_rank), group=group)
    return box[0]


def allgather_object(obj: Any, group=None) -> List[Any]:
    """Gather one picklable object per rank, ordered by rank."""
    out = [None] * dist.get_world_size(group)
    dist.all_gather_object(out, obj, group=group)
    return out
