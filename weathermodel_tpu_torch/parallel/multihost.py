"""Process-group bootstrap (port of weathermodel_tpu/parallel/multihost.py:
38-85).

The port runs one process per rank, started by `torchrun` (`python -m
torch.distributed.run`), which exports RANK, WORLD_SIZE, LOCAL_RANK and the
rendezvous address. `initialize()` joins them into one process group (the
role `jax.distributed.initialize` plays for the JAX package, and
`init_process_group` in the reference, src/utils/utils.py:77-93) and returns
the process's coordinates. Without WORLD_SIZE in the environment (a plain
`python` or `wm-pretrain-torch` run) it is the identity: one process, no
group.

    hosts = multihost.initialize("cuda")     # no-op outside torchrun
    mesh = make_mesh(n_model=2)              # parallel/mesh.py

Devices and the backend follow the layout, and are never a fallback:
  --device cuda    each rank takes cuda:LOCAL_RANK (it raises when that card
                   does not exist): one card a rank, NCCL
  --device cuda:N  every rank is pinned to card N: the ranks share it, and
                   NCCL refuses two ranks on one device, so gloo (it takes
                   CUDA tensors for all_reduce and broadcast, through host
                   copies)
  --device cpu     gloo
Rank 0 logs the backend. A failed `init_process_group` raises: nothing
catches it or retries another backend.
"""

import dataclasses
import logging
import os

import torch
import torch.distributed as dist

logger = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class HostInfo:
    host_id: int
    num_hosts: int

    @property
    def is_primary(self) -> bool:
        return self.host_id == 0


def launched() -> bool:
    """True inside a `torchrun` launch (WORLD_SIZE in the environment)."""
    return "WORLD_SIZE" in os.environ


def rank_device(device) -> torch.device:
    """The device of this rank for the entry point's `--device`: `cuda`
    is cuda:LOCAL_RANK under torchrun (cuda:0 outside it), `cuda:N` and
    `cpu` are themselves. Raises when the card does not exist."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if device.index is None:
        device = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    if not torch.cuda.is_available():
        raise RuntimeError(f"{device}: no CUDA device is available; pass "
                           "--device cpu to run on the CPU")
    if device.index >= torch.cuda.device_count():
        raise RuntimeError(f"{device} does not exist: this host has "
                           f"{torch.cuda.device_count()} CUDA device(s)")
    return device


def backend_for(device, requested) -> str:
    """The backend rule: nccl when every rank has its own card (`--device
    cuda`), gloo when the ranks share one (`--device cuda:N`) or run on the
    CPU. `requested` is the entry point's `--device` as given."""
    requested = torch.device(requested)
    if torch.device(device).type == "cuda" and requested.index is None:
        return "nccl"
    return "gloo"


def initialize(requested_device="cuda") -> HostInfo:
    """Join the torchrun launch's ranks into the default process group and
    return (rank, world size); the identity (0, 1) outside torchrun. The
    rank's device (`rank_device`) becomes the current CUDA device. A second
    call returns the group already joined."""
    if not launched():
        return HostInfo(0, 1)
    device = rank_device(requested_device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        backend = backend_for(device, requested_device)
        kwargs = {}
        if backend == "nccl":
            kwargs["device_id"] = device
        dist.init_process_group(backend, **kwargs)
        if dist.get_rank() == 0:
            logger.info("multihost: %d ranks, backend %s (--device %s)",
                        dist.get_world_size(), backend, requested_device)
    return HostInfo(dist.get_rank(), dist.get_world_size())
