"""Multi-process initialization (counterpart of
``bayesian_torch_tpu/parallel/distributed.py``).

JAX's ``jax.distributed.initialize`` becomes
``torch.distributed.init_process_group``: afterwards the world's ranks are
the devices a mesh (``parallel.make_mesh``) spans. The backend follows one
rule: NCCL when every rank of a host has a card of its own, gloo on the
CPU or when a host runs more ranks than it has cards (two ranks on one
card; NCCL refuses a duplicate device). A rank's device is
``local_device()``: card ``LOCAL_RANK mod cards``, or the CPU.

    initialize()                                   # torchrun, or one process
    initialize("10.0.0.1:29500", num_processes=8, process_id=rank)
"""

from __future__ import annotations

import datetime
import logging
import os
from typing import Optional

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)

# A rank that dies leaves the others in a collective; every group gives up
# after this long (``timeout=`` overrides it).
DEFAULT_TIMEOUT = datetime.timedelta(seconds=300)


def _local_ranks(num_processes: int) -> int:
    """Ranks on this host: torchrun's ``LOCAL_WORLD_SIZE``, else all of
    them (explicit arguments describe one host unless it says otherwise)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))


def backend_for(num_local_ranks: int) -> str:
    """NCCL when each of the host's ``num_local_ranks`` ranks has a card of
    its own, gloo otherwise (the CPU, or more ranks than cards)."""
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    return "nccl" if 0 < num_local_ranks <= cards else "gloo"


def local_device() -> torch.device:
    """This rank's device: card ``LOCAL_RANK mod cards`` when there is a
    card, else the CPU."""
    if not torch.cuda.is_available():
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank()
                               if dist.is_initialized() else 0))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, **kwargs) -> int:
    """Join the process group (a no-op on a single process).

    Explicit arguments (``coordinator_address`` as ``host:port`` or a
    ``tcp://`` URL, ``num_processes``, ``process_id``) start a ``tcp://``
    rendezvous, and a failure raises: a mis-addressed coordinator raises
    once ``timeout`` (a ``timedelta``, or ``initialization_timeout`` in
    seconds, JAX's keyword) has passed. Without arguments, torchrun's
    environment (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``) is read when it
    is set; otherwise there is one process, which is logged. Other keywords
    go to ``init_process_group``.

    Returns the number of devices a mesh can span: the world size once a
    group is up, else the visible card count (1 on the CPU).
    """
    timeout = kwargs.pop("timeout", None)
    seconds = kwargs.pop("initialization_timeout", None)
    if timeout is None:
        timeout = (datetime.timedelta(seconds=seconds) if seconds is not None
                   else DEFAULT_TIMEOUT)
    if not dist.is_initialized():
        explicit = coordinator_address is not None or (
            num_processes is not None and num_processes > 1)
        if explicit:
            if num_processes is None or process_id is None:
                raise ValueError("initialize: give num_processes and "
                                 "process_id with coordinator_address")
            url = coordinator_address or "localhost:29500"
            if "://" not in url:
                url = f"tcp://{url}"
            dist.init_process_group(
                backend_for(_local_ranks(num_processes)), init_method=url,
                world_size=num_processes, rank=process_id, timeout=timeout,
                **kwargs)
        elif "WORLD_SIZE" in os.environ and "MASTER_ADDR" in os.environ:
            world = int(os.environ["WORLD_SIZE"])
            dist.init_process_group(
                backend_for(_local_ranks(world)), init_method="env://",
                world_size=world, rank=int(os.environ["RANK"]),
                timeout=timeout, **kwargs)
        else:
            logger.info("initialize: no coordinator and no torchrun "
                        "environment; continuing as one process")
    if dist.is_initialized():
        if dist.get_backend() == "nccl":
            torch.cuda.set_device(local_device())
        return dist.get_world_size()
    return max(torch.cuda.device_count(), 1) \
        if torch.cuda.is_available() else 1
