"""Multi-process initialisation (port of ``repro/launch/distributed.py``).

Every process runs the same program; ``torch.distributed`` joins them
through the coordinator's address.  Nothing on a machine announces a
cluster, so the address, the process count and this process's rank come
from the arguments or from the reference's environment variables
(``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``); without an
address the program runs as one process.
"""
from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist


def maybe_initialize_distributed(coordinator: Optional[str] = None,
                                 num_processes: Optional[int] = None,
                                 process_id: Optional[int] = None) -> bool:
    """Initialise ``torch.distributed`` from args or the standard env vars
    (COORDINATOR_ADDRESS as ``host:port`` or a URL / NUM_PROCESSES /
    PROCESS_ID), over NCCL where CUDA is available and gloo otherwise.
    Returns True if distributed mode was initialised."""
    coordinator = coordinator or os.environ.get("COORDINATOR_ADDRESS")
    if not coordinator:
        return False
    num_processes = num_processes or int(os.environ.get("NUM_PROCESSES", "1"))
    process_id = process_id if process_id is not None \
        else int(os.environ.get("PROCESS_ID", "0"))
    url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, init_method=url,
                            world_size=num_processes, rank=process_id)
    return True


def _rank_and_world():
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def is_primary() -> bool:
    return _rank_and_world()[0] == 0


def log_topology() -> str:
    """This process's rank and devices; the primary prints it.  A process
    without CUDA counts its host as one device, and every process is
    taken to hold as many devices as this one."""
    rank, world = _rank_and_world()
    local = torch.cuda.device_count() if torch.cuda.is_available() else 1
    info = (f"process {rank}/{world} local_devices={local} "
            f"global_devices={local * world}")
    if is_primary():
        print(info, flush=True)
    return info
