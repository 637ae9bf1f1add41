"""The benchmark's fixed arithmetic for view-direction configurations,
beside `yardstick.py` (whose peaks, bender and rigidity counts it reuses):
the model FLOPs of a ray with the view branch, and the operations and
bytes of one launch of the view-direction MLP's forward and backward
kernels. Later changes to the program leave it as it is.

Model FLOPs (the rules of `yardstick.py`: matrix products only, 2 * in *
out a dense layer and point, training 3x the forward plus the divergence
jvp): the canonical MLP at its published, unpadded widths with NeRF's view
branch, a 256-wide feature and a 1-wide density layer on the trunk, one
(256 + 27) -> 128 layer and a 128 -> 3 rgb layer: 593,408 multiply-adds a
point (492,288 without the view branch). The view directions' differences
and encoding are no matrix product.

Kernel counts (`mlpv_fwd` and `mlpv_bwd`, the counting of PERF.md's kernel
table, rows 3-4): the lanes as the kernels hold them, the point encoding at
64, the direction encoding at VEMB = 32, the heads as they are packed
(alpha and rgb in 8 output lanes): 2*64*256 + 7*256*256 (the chain) +
256*256 (feature) + 256*8 (alpha) + (256 + 32)*128 (views) + 128*8 (rgb)
multiply-adds a point. The forward moves the two bf16 encodings and the
f32 raw output (224 B) a point, the backward the two encodings, the f32
cotangent and the f32 gradients of both encodings (608 B) a point, each
plus its weights (and the backward its f32 weight gradients) once a launch.
The backward recomputes the forward, runs the dh chain and the dW products:
3x the forward's products.
"""

from __future__ import annotations

from benchmark.harness import yardstick

VEMB = 32          # the direction encoding's lanes in the kernels
VW = 128           # the view layer's width, netwidth // 2

W, OUT, EMB = yardstick.WIDTH, yardstick.OUT_LANES, 64
MACS = (2 * EMB * W + 7 * W * W + W * W + W * OUT + (W + VEMB) * VW
        + VW * OUT)
BIASES = 8 * W + W + OUT + VW + OUT


def canonical_flops(model: dict) -> int:
    """Forward FLOPs of one point of the canonical MLP with its view
    branch."""
    in_ch = 3 + 6 * model["multires"]
    views = 3 + 6 * model["multires_views"]
    w = model["netwidth"]
    pairs = [(in_ch, w)]
    pairs += [(w + in_ch if i in model["skips"] else w, w)
              for i in range(model["netdepth"] - 1)]
    pairs += [(w, w), (w, 1), (w + views, w // 2), (w // 2, 3)]
    return sum(2 * i * o for i, o in pairs)


def render_flops_per_ray(model: dict) -> int:
    """Forward model FLOPs of one ray: coarse and fine pass, each distinct
    sample bent once."""
    S, I = model["N_samples"], model["N_importance"]
    bend = yardstick.bender_flops(model) + yardstick.rigidity_flops(model)
    return (S + I) * bend + (2 * S + I) * canonical_flops(model)


def train_flops_per_ray(model: dict, train: dict) -> int:
    """Model FLOPs of one training ray: 3x the forward with the
    divergence loss's jvp."""
    fwd = render_flops_per_ray(model)
    if model["ray_bending"] and train["divergence_loss_weight"] > 0.0:
        fwd += model["N_samples"] * 2 * yardstick.bender_flops(model)
    return 3 * fwd


def mlpv_fwd_work(points: int, launches: int) -> tuple:
    """(FLOPs, bytes) of `launches` forward launches over `points` points
    in all."""
    return (2 * MACS * points,
            points * (2 * EMB + 2 * VEMB + 4 * OUT)
            + launches * (2 * MACS + 4 * BIASES))


def mlpv_bwd_work(points: int, launches: int) -> tuple:
    """(FLOPs, bytes) of `launches` backward launches over `points` points
    in all."""
    return (3 * 2 * MACS * points,
            points * (2 * EMB + 2 * VEMB + 4 * OUT + 4 * EMB + 4 * VEMB)
            + launches * (2 * MACS + 4 * BIASES + 4 * (MACS + BIASES)))
