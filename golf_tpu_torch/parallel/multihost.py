"""Multi-process set-up (counterpart of ``golf_tpu.parallel.multihost``).

``golf_tpu`` initialises ``jax.distributed`` on a pod and gates host work on
process 0; here ``torchrun`` starts one process a card and ``initialize``
reads its environment (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``/``MASTER_PORT``). Each rank takes NCCL when it has a card of
its own, gloo otherwise (the CPU, or several ranks on one card); a single
process does nothing. ``make_pod_mesh`` lays the ranks out with the node as
its outer axis, as ``golf_tpu``'s DCN axis is the slice.
"""

from __future__ import annotations

import datetime
import os
import pickle
from typing import Any, Optional

import numpy as np
import torch
import torch.distributed as dist

from . import collectives
from .mesh import Mesh, make_mesh


def initialize(backend: Optional[str] = None,
               init_method: Optional[str] = None,
               world_size: Optional[int] = None,
               rank: Optional[int] = None) -> Optional[str]:
    """Initialise the default process group from ``torchrun``'s environment
    (or the arguments); returns the backend, or None for a single process
    or a group already initialised. On CUDA each rank sets its card from
    ``LOCAL_RANK``. ``backend`` None picks NCCL when every local rank has a
    card of its own, gloo otherwise."""
    if dist.is_initialized():
        return None
    world_size = int(os.environ.get("WORLD_SIZE", "1")) \
        if world_size is None else world_size
    if world_size <= 1 and init_method is None:
        return None
    rank = int(os.environ.get("RANK", "0")) if rank is None else rank
    local_rank = int(os.environ.get("LOCAL_RANK", str(rank)))
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world_size)))
    cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if backend is None:
        backend = "nccl" if cards >= local_world and cards > 0 else "gloo"
    if cards:
        torch.cuda.set_device(local_rank % cards)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(minutes=10))
    return backend


def is_main_process() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def broadcast_one_to_all(obj: Any) -> Any:
    """Rank 0's picklable object on every rank (``strategy.broadcast``),
    through a byte tensor on the backend's device."""
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return obj
    device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    payload = pickle.dumps(obj) if dist.get_rank() == 0 else b""
    size = torch.tensor([len(payload)], dtype=torch.int64, device=device)
    dist.broadcast(size, 0)
    buf = torch.zeros(int(size.item()), dtype=torch.uint8, device=device)
    if dist.get_rank() == 0:
        buf.copy_(torch.frombuffer(bytearray(payload), dtype=torch.uint8))
    dist.broadcast(buf, 0)
    return pickle.loads(buf.cpu().numpy().tobytes())


def sync_global_devices(tag: str = "") -> None:
    """A barrier over every rank (``tag`` names it in errors only)."""
    collectives.barrier()


def make_pod_mesh(nodes: Optional[int] = None, time: int = 1) -> Mesh:
    """Mesh whose outer axis is the node (``torchrun``'s
    ``LOCAL_WORLD_SIZE`` ranks a node): ranks laid out (nodes, data, time)
    and flattened to (nodes x data, time), so that the data group spans
    the nodes while a node's ranks are adjacent."""
    n = dist.get_world_size() if dist.is_initialized() else 1
    per_node = int(os.environ.get("LOCAL_WORLD_SIZE", str(n)))
    nodes = nodes or max(1, n // per_node)
    if n % (nodes * time):
        raise ValueError(f"{n} ranks over {nodes} nodes x time {time}")
    data = n // nodes // time
    order = np.arange(n).reshape(nodes, data, time)
    mesh = make_mesh(nodes * data, time)
    if not np.array_equal(order.reshape(nodes * data, time), mesh.ranks):
        raise AssertionError("pod layout differs from the mesh's")
    return mesh
