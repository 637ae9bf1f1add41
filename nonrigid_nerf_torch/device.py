"""Where the port's entry points run.

Every entry point takes `device=None`, which means `cuda`. The CPU is used
only when the caller asks for it (`device="cpu"`, as the tests do); a box
without a GPU raises here instead of quietly running on the CPU. Under a
process group (`parallel/multihost.py`), which pinned each process to its
GPU, a bare `cuda` is that GPU: `cuda:LOCAL_RANK` under torchrun.
"""

from __future__ import annotations

from typing import Optional, Union

import torch
import torch.distributed as dist

DeviceLike = Optional[Union[str, torch.device]]


def resolve_device(device: DeviceLike = None) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "nonrigid_nerf_torch runs on CUDA by default and no CUDA device "
            "is available; pass device='cpu' to run the plain PyTorch path")
    if (dev.type == "cuda" and dev.index is None and dist.is_available()
            and dist.is_initialized()):
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev
