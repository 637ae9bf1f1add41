"""The benchmark's fixed arithmetic: model FLOPs a ray, the chip's published
peaks, and the operations and bytes of one launch of the canonical MLP's
forward and backward kernels. Later changes to the program leave it as it
is, so that a share of a peak means the same before and after them.

Model FLOPs (a frozen copy of the rules of the port's `utils/flops.py`, on
a configuration's "model" dict): matrix products only, 2 * in * out a dense
layer and point; training = 3x the forward (a backward is two products a
layer); the fine pass reuses the coarse samples' bend, so each distinct
sample is bent once; the divergence loss adds a jvp of the bender (2x its
forward) on the coarse samples. Recomputation inside a kernel is not model
work.

Kernel counts (`mlp_fwd` and `mlp_bwd` at an input of E lanes, E = 64 or
128; the counting of PERF.md's kernel table): the forward does
E*256 + 7*256*256 + E*256 + 256*8 multiply-adds a point and moves the bf16
input (2E bytes) and the f32 output (32 bytes) a point, plus its weights
once a launch; the backward recomputes the forward, runs the dh chain and
the dW products (3x the forward's products: its inputs hold no
activations), and moves the bf16 input, the f32 cotangent (32 bytes) and
the f32 input gradient (4E bytes) a point, plus its weights and its f32
weight gradients once a launch.
"""

from __future__ import annotations

from typing import Optional

# dense bf16 peak and HBM bandwidth of one card, keyed on the name
# torch.cuda.get_device_name gives without its "NVIDIA " prefix. Source:
# NVIDIA's H100 datasheet, the SXM5 part at its 700 W limit.
PEAKS = {"H100 80GB HBM3": {"bf16_flops": 989.4e12, "hbm_bytes": 3.35e12}}

WIDTH = 256        # the canonical MLP's width, as the kernels hold it
OUT_LANES = 8      # raw output lanes a point


def peaks(device_name: str) -> Optional[dict]:
    """The published peaks of a card, or None where the table lacks it."""
    return PEAKS.get(device_name.strip().removeprefix("NVIDIA ").strip())


def _dense(pairs) -> int:
    return sum(2 * i * o for i, o in pairs)


def canonical_flops(model: dict) -> int:
    """Forward FLOPs of one canonical-MLP point query."""
    in_ch = 3 + 6 * model["multires"]
    if model["time_conditioned_baseline"]:
        in_ch += model["ray_bending_latent_size"]
    w = model["netwidth"]
    pairs = [(in_ch, w)]
    pairs += [(w + in_ch if i in model["skips"] else w, w)
              for i in range(model["netdepth"] - 1)]
    pairs.append((w, 5 if model["N_importance"] > 0 else 4))
    return _dense(pairs)


def bender_flops(model: dict) -> int:
    if not model["ray_bending"]:
        return 0
    pairs, fan_in = [], 3 + model["ray_bending_latent_size"]
    for _ in range(model["bending_depth"] - 1):
        pairs.append((fan_in, model["bending_width"]))
        fan_in = model["bending_width"]
    pairs.append((fan_in, 3))
    return _dense(pairs)


def rigidity_flops(model: dict) -> int:
    if not (model["ray_bending"] and model["use_rigidity_network"]):
        return 0
    pairs, fan_in = [], 3
    for _ in range(model["rigidity_depth"] - 1):
        pairs.append((fan_in, model["rigidity_width"]))
        fan_in = model["rigidity_width"]
    pairs.append((fan_in, 1))
    return _dense(pairs)


def render_flops_per_ray(model: dict) -> int:
    """Forward model FLOPs of one ray: coarse and fine pass."""
    S, I = model["N_samples"], model["N_importance"]
    total = (S + I) * (bender_flops(model) + rigidity_flops(model))
    total += S * canonical_flops(model)
    total += (S + I) * canonical_flops(model)
    return total


def train_flops_per_ray(model: dict, train: dict) -> int:
    """Model FLOPs of one training ray: 3x the forward with the
    divergence loss's jvp."""
    fwd = render_flops_per_ray(model)
    if model["ray_bending"] and train["divergence_loss_weight"] > 0.0:
        fwd += model["N_samples"] * 2 * bender_flops(model)
    return 3 * fwd


def kernel_lanes(model: dict) -> int:
    """The canonical MLP kernels' input lanes: the encoding (and for the
    time-conditioned baseline the latent) padded to a multiple of 64."""
    ch = 3 + 6 * model["multires"]
    if model["time_conditioned_baseline"]:
        ch += model["ray_bending_latent_size"]
    return -(-ch // 64) * 64


def _macs(lanes: int) -> int:
    return 2 * lanes * WIDTH + 7 * WIDTH * WIDTH + WIDTH * OUT_LANES


def _weight_floats(lanes: int) -> tuple:
    """(matrix entries, bias entries) of the packed weights."""
    return 2 * lanes * WIDTH + 7 * WIDTH * WIDTH + WIDTH * OUT_LANES, \
        8 * WIDTH + OUT_LANES


def mlp_fwd_work(points: int, launches: int, lanes: int) -> tuple:
    """(FLOPs, bytes) of `launches` forward launches over `points` points in
    all."""
    mats, biases = _weight_floats(lanes)
    return (2 * _macs(lanes) * points,
            points * (2 * lanes + 4 * OUT_LANES)
            + launches * (2 * mats + 4 * biases))


def mlp_bwd_work(points: int, launches: int, lanes: int) -> tuple:
    """(FLOPs, bytes) of `launches` backward launches over `points` points
    in all."""
    mats, biases = _weight_floats(lanes)
    return (3 * 2 * _macs(lanes) * points,
            points * (2 * lanes + 4 * OUT_LANES + 4 * lanes)
            + launches * (2 * mats + 4 * biases + 4 * (mats + biases)))


def least_seconds(flops: float, nbytes: float, card: dict) -> float:
    """The least time at the published peaks: the larger of the operations
    over the bf16 rate and the bytes over the memory rate."""
    return max(flops / card["bf16_flops"], nbytes / card["hbm_bytes"])
