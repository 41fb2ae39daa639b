"""Several processes under torch.distributed: the port's ``jax.distributed``
and ``multihost_utils``.

The reference joins its processes with ``jax.distributed.initialize`` and
then sees one global device list; ``multihost_utils.process_allgather``
collects a host array from every process. Here a process group stands in
for both:

* ``initialize`` joins this process to the group over a
  ``tcp://<address>`` rendezvous, with a short timeout so that a missing
  or dead peer fails a collective instead of waiting out c10d's
  30-minute default;
* ``process_index`` / ``process_count`` are the rank and the world size
  (0 and 1 with no group up);
* ``process_allgather`` stacks a numpy array from every rank in rank
  order;
* ``all_gather_stacked`` is the one collective the mesh's cross-process
  path uses (parallel/mesh.py): a tensor from every rank, in rank order.

Gloo is the backend on one card: NCCL refuses two ranks on one GPU.
Gloo's ``all_gather`` takes CPU tensors only, so a gather under gloo
stages CUDA tensors through pinned host memory; under NCCL (one card a
rank, after ``torch.cuda.set_device(rank)``) the tensors stay on the
cards. A failed collective raises; nothing here catches it.
"""

from __future__ import annotations

import socket
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# seconds a rendezvous or a collective waits for a peer before it raises
DEFAULT_TIMEOUT_S = 90.0


def free_port() -> int:
    """A TCP port on 127.0.0.1 that was free when asked. Another process
    may take it before the rendezvous binds it; the caller retries then."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def initialize(coordinator_address: str, num_processes: int, process_id: int,
               backend: str = "gloo", timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join the process group: ``coordinator_address`` is ``host:port``,
    where rank 0 listens; every collective after this raises when a peer
    has not answered within ``timeout_s``."""
    dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=timeout_s))


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if is_initialized() else 1


def shutdown() -> None:
    if is_initialized():
        dist.destroy_process_group()


def all_gather_stacked(t: torch.Tensor) -> torch.Tensor:
    """``t`` from every rank, stacked in rank order: (world, *t.shape).
    Every rank passes the same shape and dtype. Under gloo the result is
    on the host (pinned when ``t`` is on a card); under NCCL on this
    rank's card (``torch.cuda.set_device``)."""
    world = dist.get_world_size()
    backend = dist.get_backend()
    if backend == "gloo" and t.device.type != "cpu":
        host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t)
        t = host
    elif backend == "nccl" and t.device.type != "cuda":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    out = torch.empty((world, *t.shape), dtype=t.dtype, device=t.device,
                      pin_memory=t.is_pinned())
    dist.all_gather(list(out.unbind(0)), t.contiguous())
    return out


def process_allgather(arr) -> np.ndarray:
    """``arr`` from every process stacked in rank order, as
    ``multihost_utils.process_allgather`` gives it; with no group up, the
    array with a leading axis of 1."""
    a = np.ascontiguousarray(arr)
    if not is_initialized():
        return a[None]
    return all_gather_stacked(torch.from_numpy(a)).cpu().numpy()
