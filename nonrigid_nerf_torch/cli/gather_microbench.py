"""Microbench: random-pixel gathers against a large device-resident image
stack (the hot path of `data/dataset.py:sample_ray_batch` at scale)
(counterpart of the JAX package's tools/gather_microbench.py).

    python3 -m nonrigid_nerf_torch.cli.gather_microbench [--n 900]
        [--h 720] [--w 1280] [--rays 1024] [--iters 200] [--device cuda]

Times, per draw of `--rays` random pixels (image id, x, y drawn on the
device each call) against an (N, H, W, 3) uint8 stack:

  a) 4-D advanced indexing  images[ids, y, x]
  b) row gather             flat[linear_pixel_index(ids, y, x)] on (N*H*W, 3)
                            (what sample_ray_batch does; int64 index)
  c) index_select           index_select(flat, 0, linear_pixel_index(...))

each returning the pixels as f32 in [0, 1]. Times are CUDA events over
`--iters` calls after a warm-up (the host clock on the CPU, and it says so).
Defaults: the 900 x 720 x 1280 stack of data_r5/scale300 (2.49 GB); the
bench's stack is 86 x 384 x 512.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import torch

from nonrigid_nerf_torch.data.dataset import linear_pixel_index
from nonrigid_nerf_torch.device import resolve_device


def gather_4d(images, flat, ids, y, x):
    return images[ids, y, x].to(torch.float32) / 255.0


def gather_flat_rows(images, flat, ids, y, x):
    lin = linear_pixel_index(ids, y, x, images.shape[1], images.shape[2])
    return flat[lin].to(torch.float32) / 255.0


def gather_index_select(images, flat, ids, y, x):
    lin = linear_pixel_index(ids, y, x, images.shape[1], images.shape[2])
    return torch.index_select(flat, 0, lin).to(torch.float32) / 255.0


GATHERS = (("a_4d_advanced", gather_4d), ("b_flat_rows", gather_flat_rows),
           ("c_index_select", gather_index_select))


def random_stack(n: int, h: int, w: int, device, seed: int = 0):
    """(n, h, w, 3) uint8 drawn on the device from `seed`."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, (n, h, w, 3), generator=gen,
                         dtype=torch.uint8, device=device)


def draw(n: int, h: int, w: int, rays: int, gen, device):
    """`rays` uniform (image id, y, x) on the device."""
    return tuple(torch.randint(0, high, (rays,), generator=gen, device=device)
                 for high in (n, h, w))


def time_ms(fn, device, iters: int) -> float:
    """Milliseconds a call over `iters` calls, after one warm-up call."""
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(end) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def run_gathers(n: int, h: int, w: int, rays: int, iters: int,
                device=None) -> dict:
    from nonrigid_nerf_torch.cli.bench import card_name_and_power_limit
    device = resolve_device(device)
    name, power_limit = card_name_and_power_limit(device)
    images = random_stack(n, h, w, device)
    flat = images.reshape(n * h * w, 3)
    gen = torch.Generator(device=device).manual_seed(0)
    rows = {}
    for label, gather in GATHERS:
        ms = time_ms(lambda: gather(images, flat, *draw(n, h, w, rays, gen,
                                                         device)),
                     device, iters)
        rows[label] = ms
        print(f"{label}: {ms:.3f} ms / {rays} pixels  (stack {n}x{h}x{w}, "
              f"{images.numel() / 1e9:.2f} GB)", flush=True)
    return {"device": name, "power_limit_w": power_limit,
            "clock": "CUDA events" if device.type == "cuda" else
            "host clock (CPU)", "stack": [n, h, w], "rays": rays,
            "ms": rows}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--n", type=int, default=900)
    p.add_argument("--h", type=int, default=720)
    p.add_argument("--w", type=int, default=1280)
    p.add_argument("--rays", type=int, default=1024)
    p.add_argument("--iters", type=int, default=200)
    p.add_argument("--device", default=None,
                   help="where the stack lives: cuda (the default) or cpu")
    args = p.parse_args(argv)
    out = run_gathers(args.n, args.h, args.w, args.rays, args.iters,
                      args.device)
    print(f"device: {out['device']}, {out['power_limit_w']} W; timed with "
          f"{out['clock']}")
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
