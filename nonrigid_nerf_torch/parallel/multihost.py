"""Process-group bring-up for data parallelism over GPUs
(counterpart of nonrigid_nerf_tpu/parallel/multihost.py).

The JAX package runs one process per host and a mesh over its devices; the
port runs one process per GPU, PyTorch's idiom, launched by
`python3 -m torch.distributed.run` (torchrun). This module does what such a
process needs around the data-parallel step of `parallel/mesh.py`:

1. bring-up: `maybe_initialize()` starts `torch.distributed` from the
   environment and pins the process to its GPU before any tensor exists;
2. replication: `replicate(model)` broadcasts rank 0's parameters and
   buffers, so every rank starts from the same weights;
3. IO discipline: exactly one process writes checkpoints, logs and renders
   (`is_main()`), and `barrier()` orders filesystem events (the
   --no_reload wipe, a save) against the other processes.

Two environment contracts are accepted, set on every process:
  torchrun's  RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT
  the JAX package's  NRNERF_COORDINATOR (host:port of process 0),
              NRNERF_NUM_PROCESSES, NRNERF_PROCESS_ID (LOCAL_RANK, where
              set, picks the GPU; else the process id does)
With neither, the process runs alone and nothing is initialized.

The backend follows the device: `nccl` for cuda, `gloo` for the CPU. An
explicit backend must carry that device's tensors: `nccl` takes CUDA
tensors only; `gloo` takes CPU tensors, and CUDA tensors for `broadcast`,
`all_reduce` and `barrier`, which is all this package uses, so it serves
several ranks that share one GPU, where NCCL refuses. Anything else raises;
nothing falls back to another backend or device.
"""

from __future__ import annotations

import datetime
import itertools
import os
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

from nonrigid_nerf_torch.device import DeviceLike

TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                "MASTER_PORT")
NRNERF_ENV = ("NRNERF_COORDINATOR", "NRNERF_NUM_PROCESSES",
              "NRNERF_PROCESS_ID")
TIMEOUT = datetime.timedelta(minutes=30)


def _missing(names, what: str) -> None:
    missing = [v for v in names if v not in os.environ]
    if missing:
        raise RuntimeError(
            "%s %s missing; %s needs all of %s"
            % (" and ".join(missing), "is" if len(missing) == 1 else "are",
               what, ", ".join(names)))


def backend_for(device: DeviceLike = None, backend: Optional[str] = None
                ) -> str:
    """The backend for `device` (cuda unless given): `nccl` for cuda and
    `gloo` for the CPU, or `backend` when it carries that device's
    tensors."""
    dev = torch.device("cuda" if device is None else device)
    if backend is None:
        return "nccl" if dev.type == "cuda" else "gloo"
    if backend == "nccl" and dev.type == "cuda":
        return backend
    if backend == "gloo" and dev.type in ("cuda", "cpu"):
        return backend
    raise ValueError(f"backend {backend!r} does not carry {dev.type} "
                     "tensors: use nccl for cuda, gloo for the CPU (or gloo "
                     "for ranks that share one GPU)")


def initialize(rank: int, world_size: int, init_method: str,
               device: DeviceLike = None, backend: Optional[str] = None,
               local_rank: Optional[int] = None) -> torch.device:
    """Join a process group of `world_size` ranks as `rank`, on `device`
    (cuda unless given). A bare `cuda` becomes `cuda:<local_rank>` (default
    `rank`), an indexed one is kept (ranks that share a GPU), and the
    process is pinned to it before any tensor exists. Returns the
    device."""
    dev = torch.device("cuda" if device is None else device)
    backend = backend_for(dev, backend)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("a process group on cuda, and no CUDA device "
                               "is available; pass device='cpu' for gloo on "
                               "the CPU")
        if dev.index is None:
            dev = torch.device("cuda", rank if local_rank is None
                               else local_rank)
        torch.cuda.set_device(dev)
    kwargs = {"device_id": dev} if backend == "nccl" else {}
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size, timeout=TIMEOUT, **kwargs)
    return dev


def maybe_initialize(device: DeviceLike = None) -> int:
    """Start `torch.distributed` from the environment when it names a
    process group (module docstring); returns the world size (1 when the
    process runs alone). Idempotent. Call it before the first tensor."""
    if is_initialized():
        return dist.get_world_size()
    if any(v in os.environ for v in ("RANK", "WORLD_SIZE")):
        _missing(TORCHRUN_ENV, "a torchrun process group")
        initialize(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                   "env://", device, local_rank=int(os.environ["LOCAL_RANK"]))
    elif "NRNERF_COORDINATOR" in os.environ:
        _missing(NRNERF_ENV, "an explicit NRNERF_* process group")
        rank = int(os.environ["NRNERF_PROCESS_ID"])
        initialize(rank, int(os.environ["NRNERF_NUM_PROCESSES"]),
                   "tcp://" + os.environ["NRNERF_COORDINATOR"], device,
                   local_rank=int(os.environ.get("LOCAL_RANK", rank)))
    else:
        return 1
    return dist.get_world_size()


def is_initialized() -> bool:
    return dist.is_available() and dist.is_initialized()


def world_size() -> int:
    return dist.get_world_size() if is_initialized() else 1


def rank() -> int:
    return dist.get_rank() if is_initialized() else 0


def is_main() -> bool:
    return rank() == 0


def barrier() -> None:
    """Block until every rank reaches this point (no-op alone)."""
    if world_size() > 1:
        dist.barrier()


def broadcast_from_main(value):
    """Rank 0's `value` (any picklable object) on every rank; alone,
    `value` itself. Every rank must call it."""
    if world_size() > 1:
        box = [value]
        dist.broadcast_object_list(box, src=0)
        value = box[0]
    return value


def flatten(tensors: List[torch.Tensor]) -> torch.Tensor:
    """One flat buffer holding `tensors` (one dtype) one after another."""
    return torch.cat([t.detach().reshape(-1) for t in tensors])


def unflatten(flat: torch.Tensor, like: List[torch.Tensor]
              ) -> List[torch.Tensor]:
    """Views of `flat` shaped as `like`, the inverse of `flatten`."""
    parts = flat.split([t.numel() for t in like])
    return [p.view_as(t) for p, t in zip(parts, like)]


def replicate(model: torch.nn.Module) -> torch.nn.Module:
    """Give every rank rank 0's parameters and buffers: one broadcast of
    them all, flattened (one a dtype). Alone, the model is returned as it
    is. Every rank must call it."""
    if world_size() > 1:
        groups: Dict[torch.dtype, List[torch.Tensor]] = {}
        for t in itertools.chain(model.parameters(), model.buffers()):
            groups.setdefault(t.dtype, []).append(t)
        for group in groups.values():
            flat = flatten(group)
            dist.broadcast(flat, src=0)
            with torch.no_grad():
                for t, v in zip(group, unflatten(flat, group)):
                    t.copy_(v)
    return model
