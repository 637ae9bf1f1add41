#!/usr/bin/env python3
"""Two probes on one GPU behind design notes of PERF.md section 6.

    python3 chip_probes.py mm_out_dtype   # from the repository root
    python3 chip_probes.py rob_draws

`mm_out_dtype`: whether torch's bf16 GEMM with an f32 output
(`torch.mm(a, b, out_dtype=torch.float32)`) has a backward and a
forward-mode formula; `models/mlp.py:dense_apply` needs both (autograd, and
the jvps of the view directions and the divergence loss).

`rob_draws`: `fused_bwd` against `fused_bwd_plain` at one launch of
262,144 and of 131,072 points on six draws each, and at chip_smoke.py's
2^18 + 129 points per piece: the rigidity head's bias gradient `rob` of
the kernel and of the plain version, its error over its own magnitude,
and `fused_bwd_agreement`'s verdict and worst relative L2.
"""

import os
import sys

import torch


def mm_out_dtype() -> int:
    a = torch.randn(4, 3, dtype=torch.bfloat16, device="cuda",
                    requires_grad=True)
    b = torch.randn(3, 5, dtype=torch.bfloat16, device="cuda")
    try:
        torch.mm(a, b, out_dtype=torch.float32).sum().backward()
        print("mm.dtype backward ok", a.grad.dtype)
    except Exception as e:  # noqa: BLE001 - the answer is the message
        print("mm.dtype backward:", str(e)[:200])
    import torch.autograd.forward_ad as fwAD
    try:
        with fwAD.dual_level():
            d = fwAD.make_dual(a.detach(), torch.ones_like(a.detach()))
            torch.mm(d, b, out_dtype=torch.float32)
            print("mm.dtype forward AD ok")
    except Exception as e:  # noqa: BLE001
        print("mm.dtype forward AD:", str(e)[:200])
    return 0


def rob_draws() -> int:
    sys.path.insert(0, os.getcwd())
    import chip_smoke as cs
    from nonrigid_nerf_torch.config import load_args, model_config_from_args
    from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = model_config_from_args(load_args("configs/example_sequence.txt"))
    model = cs.flagship_model(cfg, dev)
    w = cs.fused_weights(model, dev, "fine")
    piece = 1 << 18

    def rob(g):
        return g[2][15].flatten()[0].item()

    cases = ([((1 << 18) + 129, cs.SEED + (1 << 18) + 129 + 2)]
             + [(1 << 18, 500 + s) for s in range(6)]
             + [(131072, 600 + s) for s in range(6)])
    for n, seed in cases:
        pts, lat, gen = cs.fused_inputs(model, n, dev, seed)
        cots = [torch.randn((n, c), generator=gen, device=dev)
                for c in (8, 3, 1)]
        parts = [slice(0, min(n, piece))] + (
            [slice(piece, n)] if n > piece else [])
        out = []
        with torch.no_grad():
            for sl in parts:
                args = (pts[sl], lat[sl], w, *(c[sl] for c in cots))
                k, p = FB.fused_bwd(*args), FB.fused_bwd_plain(*args)
                st = FB.fused_bwd_agreement(k, p)
                out.append((sl.stop - sl.start, round(rob(k), 5),
                            round(rob(p), 5), round(st["max_rel"]["rob"], 5),
                            st["ok"], round(st["grad_l2_rel"], 5)))
        print(n, seed, out, flush=True)
    return 0


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_probes: no CUDA device", file=sys.stderr)
        return 1
    probes = {"mm_out_dtype": mm_out_dtype, "rob_draws": rob_draws}
    if sys.argv[1:2] == [] or sys.argv[1] not in probes:
        print(f"usage: chip_probes.py {{{','.join(probes)}}}", file=sys.stderr)
        return 2
    return probes[sys.argv[1]]()


if __name__ == "__main__":
    sys.exit(main())
