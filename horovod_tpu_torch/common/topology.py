"""Process topology: rank/size/local/cross coordinates, read from the
launcher's environment (:mod:`horovod_tpu.common.topology`).

``horovodrun`` sets ``HOROVOD_RANK/SIZE/LOCAL_RANK/LOCAL_SIZE/
CROSS_RANK/CROSS_SIZE``; ``mpirun`` sets the ``OMPI_COMM_WORLD_*``
fallbacks. With neither, the topology is one process. On GPUs
``local_rank`` picks the card (:func:`horovod_tpu_torch.parallel.mesh.
init_process_group`).
"""

from __future__ import annotations

import dataclasses
import os


@dataclasses.dataclass(frozen=True)
class Topology:
    rank: int = 0
    size: int = 1
    local_rank: int = 0
    local_size: int = 1
    cross_rank: int = 0
    cross_size: int = 1

    def __post_init__(self):
        if not (0 <= self.rank < self.size):
            raise ValueError(f"rank {self.rank} out of range for size {self.size}")
        if not (0 <= self.local_rank < self.local_size):
            raise ValueError(
                f"local_rank {self.local_rank} out of range for local_size {self.local_size}")
        if not (0 <= self.cross_rank < self.cross_size):
            raise ValueError(
                f"cross_rank {self.cross_rank} out of range for cross_size {self.cross_size}")

    @property
    def is_homogeneous(self) -> bool:
        return self.size == self.local_size * self.cross_size


def _env_int(names, default):
    for n in names:
        v = os.environ.get(n)
        if v is not None:
            return int(v)
    return default


def topology_from_env() -> Topology:
    """Build topology from launcher env vars (or single-process default)."""
    size = _env_int(["HOROVOD_SIZE", "OMPI_COMM_WORLD_SIZE"], 1)
    rank = _env_int(["HOROVOD_RANK", "OMPI_COMM_WORLD_RANK"], 0)
    local_size = _env_int(["HOROVOD_LOCAL_SIZE", "OMPI_COMM_WORLD_LOCAL_SIZE"], size if size else 1)
    local_rank = _env_int(["HOROVOD_LOCAL_RANK", "OMPI_COMM_WORLD_LOCAL_RANK"], rank)
    cross_size = _env_int(["HOROVOD_CROSS_SIZE"], max(1, size // max(1, local_size)))
    cross_rank = _env_int(["HOROVOD_CROSS_RANK"], rank // max(1, local_size))
    return Topology(rank=rank, size=size, local_rank=local_rank,
                    local_size=local_size, cross_rank=cross_rank, cross_size=cross_size)
