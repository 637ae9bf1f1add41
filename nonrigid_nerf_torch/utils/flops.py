"""Static model-FLOP accounting for MFU reporting
(counterpart of nonrigid_nerf_tpu/utils/flops.py).

Everything here is derived from the config alone, so the bench can report
hardware-independent numbers next to rays/s: `model_tflops_per_sec` and
`mfu_vs_bf16_peak`. The integers are the JAX package's, case for case.

Conventions (kept from the JAX package so that the numbers compare):

- Only MATMUL FLOPs are counted (2 * in * out per dense layer per point).
  Positional encodings, activations, compositing, sorting, Adam, and the
  loss arithmetic are excluded: they are an O(width) sliver next to the
  O(width^2) dense chain, so MFU is a slight UNDERESTIMATE.
- "Model FLOPs" are the ALGORITHM's required FLOPs, not the FLOPs executed:
  recomputes inside a backward (the kernels' backward recomputes the
  forward's activations) do not count, while genuine algorithmic work (the
  divergence-loss jvp, the exact-viewdirs jvp) does.
- Training counts forward + backward as 3x forward (each dense backward is
  two matmuls: dL/dx and dL/dW). A jvp costs 2x the primal forward and is
  itself differentiated, so it contributes 3 * 2x.
- The fine pass reuses the coarse samples' stage-1 (bend + encode) results
  when `cfg.stage1_reuse` is on (engine/render.py), so bend work is counted
  once per distinct sample point; the reference re-bends (reference
  train.py:910-941), but the FLOPs here describe THIS implementation.
"""

from __future__ import annotations

from typing import Optional

import torch

from nonrigid_nerf_torch.config import ModelConfig


def _dense_chain_flops(pairs) -> int:
    """2 * in * out summed over (in, out) layer shapes: per point, forward."""
    return int(sum(2 * i * o for i, o in pairs))


def canonical_mlp_flops(cfg: ModelConfig, network: str = "coarse") -> int:
    """Forward matmul FLOPs of one canonical-MLP point query
    (models/nerf.py:NeRF)."""
    D = cfg.netdepth if network == "coarse" else cfg.netdepth_fine
    W = cfg.netwidth if network == "coarse" else cfg.netwidth_fine
    input_ch = cfg.input_ch
    if cfg.time_conditioned_baseline:
        input_ch += cfg.ray_bending_latent_size
    pairs = [(input_ch, W)]
    for i in range(D - 1):
        pairs.append((W + input_ch if i in cfg.skips else W, W))
    if cfg.use_viewdirs:
        pairs += [(W, W), (W, 1), (cfg.input_ch_views + W, W // 2),
                  (W // 2, 3)]
    else:
        pairs += [(W, cfg.output_ch)]
    return _dense_chain_flops(pairs)


def bender_flops(cfg: ModelConfig) -> int:
    """Forward matmul FLOPs of one bending-MLP point query
    (models/bending.py:BendingNetwork.unmasked_offsets)."""
    if not cfg.use_ray_bending:
        return 0
    pairs, in_dim = [], 3 + cfg.ray_bending_latent_size
    for _ in range(cfg.bending_depth - 1):
        pairs.append((in_dim, cfg.bending_width))
        in_dim = cfg.bending_width
    pairs.append((in_dim, 3))
    return _dense_chain_flops(pairs)


def rigidity_flops(cfg: ModelConfig) -> int:
    """Forward matmul FLOPs of one rigidity-MLP point query
    (models/bending.py:BendingNetwork.rigidity_mask)."""
    if not (cfg.use_ray_bending and cfg.use_rigidity_network):
        return 0
    pairs, in_dim = [], 3
    for _ in range(cfg.rigidity_depth - 1):
        pairs.append((in_dim, cfg.rigidity_width))
        in_dim = cfg.rigidity_width
    pairs.append((in_dim, 1))
    return _dense_chain_flops(pairs)


def render_flops_per_ray(cfg: ModelConfig) -> int:
    """Forward-only model FLOPs of rendering one ray (coarse + fine pass)."""
    S, I = cfg.N_samples, cfg.N_importance
    bend = bender_flops(cfg) + rigidity_flops(cfg)
    n_union = S + I if I > 0 else S
    # distinct sample points bent once under reuse; re-bent otherwise
    n_bend = (S + I) if (cfg.stage1_reuse or I == 0) else (S + n_union)
    total = n_bend * bend
    total += S * canonical_mlp_flops(cfg, "coarse")
    if I > 0:
        total += n_union * canonical_mlp_flops(cfg, "fine")
    if cfg.use_viewdirs and cfg.use_ray_bending \
            and not cfg.approx_nonrigid_viewdirs:
        # exact nonrigid viewdirs: one jvp of the bender per queried point
        # and pass (engine/query.py:sample_viewdirs), 2x a bender forward
        total += n_bend * 2 * bender_flops(cfg)
    return int(total)


def train_flops_per_ray(cfg: ModelConfig, divergence_weight: float = 1.0,
                        divergence_exact: bool = False,
                        n_backwards: int = 1) -> int:
    """Model FLOPs of one training step, per ray (forward + backward).

    `n_backwards`: cotangents pulled through the one forward. The block
    train/test split (engine/train_step.py:losses_and_grads) pulls TWO, the
    reference's two backward passes over one retained graph (reference
    train.py:1594-1608), so its algorithmic cost is (1 + 2*2) = 5x a
    forward; the default is 3x.
    """
    fwd = render_flops_per_ray(cfg)
    if cfg.use_ray_bending and divergence_weight > 0.0:
        # the divergence loss re-bends the S coarse points under a jvp
        # (engine/losses.py): 2x bender per probe
        probes = 3 if divergence_exact else 1
        fwd += cfg.N_samples * probes * 2 * bender_flops(cfg)
    return int((1 + 2 * n_backwards) * fwd)


# dense bf16 peak per GPU, TFLOP/s, without sparsity, keyed on the name
# torch.cuda.get_device_name gives (the "NVIDIA " prefix dropped). Source:
# NVIDIA's H100 datasheet, the SXM5 part at its 700 W limit.
_BF16_PEAK_TFLOPS = {
    "H100 80GB HBM3": 989.4,
}


def device_bf16_peak_tflops(device) -> Optional[float]:
    """Dense bf16 peak of a CUDA device (a torch.device, "cuda:0" or an
    index), or None where unknown: the CPU and GPUs not in the table."""
    if isinstance(device, int):
        device = torch.device("cuda", device)
    device = torch.device(device)
    if device.type != "cuda":
        return None
    name = torch.cuda.get_device_name(device).strip()
    return _BF16_PEAK_TFLOPS.get(name.removeprefix("NVIDIA ").strip())
