"""Which host of a corpus job this process is, and its share of the files.

Counterpart of ``audiotoken_tpu/parallel/mesh.py:shard_files_for_host``:
the hosts of a corpus job share nothing but the assignment of files, a
deterministic ``i % process_count == process_index`` over the sorted list.
The host's rank and count come from ``torch.distributed`` when a process
group is initialised, else the process is the only host.
"""

from typing import List, Optional, Sequence

import torch.distributed as dist


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def shard_files_for_host(
    files: Sequence[str], index: Optional[int] = None, count: Optional[int] = None
) -> List[str]:
    """The files of host ``index`` of ``count`` (default: this process's):
    every ``count``-th of the sorted list, from the ``index``-th on."""
    pi = process_index() if index is None else index
    pc = process_count() if count is None else count
    return [f for i, f in enumerate(sorted(files)) if i % pc == pi]
