"""The point query: sample points -> (bend) -> encode -> canonical MLP
(counterpart of nonrigid_nerf_tpu/engine/query.py:59-83,127-266).

Stage 1 (`bend_encode_stage`) is network-independent, so the renderer runs
it once per sample point and the fine pass reuses the coarse samples'
results. Stage 2 (`canonical_mlp_stage`) runs the coarse or fine MLP, as the
CUDA kernels when `use_fused_kernel` says so: `mlp_fwd` alone where no
gradient is recorded (rendering), and the autograd function `MLPCore`
(forward `mlp_fwd`, backward `mlp_bwd`) where one is (training).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from nonrigid_nerf_torch.config import EditConfig, ModelConfig
from nonrigid_nerf_torch.ops.embedding import fourier_embed
from nonrigid_nerf_torch.ops.kernels.mlp_bwd import MLPCore
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    OUT_PAD, cast_mlp_weights, mlp_fwd, pack_mlp_weights, pad_lanes)


def supports_fused_query(cfg: ModelConfig) -> bool:
    """Whether the `mlp_fwd` kernel covers this canonical MLP: 8 x 256 with
    the skip at 4 for both networks, the 63-channel encoding, no view
    directions and no time-conditioned input (those take other kernels)."""
    return (not cfg.use_viewdirs
            and not cfg.time_conditioned_baseline
            and cfg.i_embed == 0 and cfg.multires == 10
            and cfg.netdepth == 8 and cfg.netwidth == 256
            and (cfg.N_importance <= 0
                 or (cfg.netdepth_fine == 8 and cfg.netwidth_fine == 256))
            and tuple(cfg.skips) == (4,))


def edits_active(edit: EditConfig) -> bool:
    return (edit.rigidity_test_time_cutoff is not None
            or edit.test_time_scaling is not None
            or edit.nonrigid_object_removal_threshold is not None
            or edit.render_canonical)


def use_fused_kernel(cfg: ModelConfig, edit: EditConfig,
                     device: torch.device) -> bool:
    """Whether stage 2 runs through `mlp_fwd`.

    "off": never. "on": always, and an error where the configuration or a
    scene edit is outside the kernel's support (on a CPU device `mlp_fwd`
    runs its plain version). "auto": on a CUDA device whenever "on" would
    be allowed; a scene edit turns it off. The JAX package turns "auto" off
    for rendering from a TPU v5e timing; that timing says nothing about
    this card, so here "auto" takes the kernel."""
    mode = cfg.fused_kernel
    if mode == "off":
        return False
    if mode not in ("auto", "on"):
        raise NotImplementedError(f"fused_kernel={mode!r} is not ported yet")
    if not supports_fused_query(cfg) or edits_active(edit):
        if mode == "on":
            raise ValueError(
                f"fused_kernel={mode!r} but the configuration (architecture, "
                "viewdirs, or scene edits) is outside the kernel's support; "
                "use fused_kernel='auto'")
        return False
    return mode == "on" or torch.device(device).type == "cuda"


def bend_encode_stage(model, cfg: ModelConfig, pts, latents,
                      edit: EditConfig = EditConfig(), fused: bool = False,
                      detailed: bool = False):
    """Stage 1: deformation field + positional encoding.

    pts (R, S, 3); latents (R, L) per ray. Returns a dict with
    embedded (R, S, input_ch), bent_pts (R, S, 3), rigidity (R, S, 1) or
    None, and details: None, or with `detailed` the internals the
    regularizers read (initial_input_pts and input_pts, both detached, and
    the bender's unmasked_offsets, rigidity_mask, masked_offsets).

    With `fused` and no gradient being recorded the encoding is cast to
    bf16 here (the kernel reads bf16, so the tensor between the stages is
    half as wide); under autograd it stays f32 and `MLPCore` casts, so the
    f32 gradient of the encoding comes back unrounded."""
    R, S = pts.shape[:-1]
    details = {"initial_input_pts": pts.detach()} if detailed else None
    rigidity = None
    if model.bender is not None and not edit.render_canonical:
        latents_per_pt = latents[:, None, :].expand(R, S, latents.shape[-1])
        bent_pts, bend_details = model.bender(
            pts, latents_per_pt,
            rigidity_test_time_cutoff=edit.rigidity_test_time_cutoff,
            test_time_scaling=edit.test_time_scaling)
        rigidity = bend_details.get("rigidity_mask")
        if detailed:
            details.update(bend_details)
    else:
        bent_pts = pts
    if detailed:
        details["input_pts"] = bent_pts.detach()
    # encode in f32 (sin(2^9 x) needs its mantissa), cast for the kernel
    embedded = bent_pts if cfg.i_embed == -1 else fourier_embed(bent_pts,
                                                                 cfg.multires)
    if fused and not torch.is_grad_enabled():
        embedded = embedded.to(torch.bfloat16)
    return {"embedded": embedded, "bent_pts": bent_pts, "rigidity": rigidity,
            "details": details}


def canonical_mlp_stage(model, cfg: ModelConfig, network: str, stage1,
                        edit: EditConfig = EditConfig(), fused: bool = False):
    """Stage 2: the coarse or fine canonical MLP on stage 1's encoding, then
    the foreground-removal edit. Returns raw (R, S, 4) f32."""
    embedded = stage1["embedded"]
    net = model.network(network)
    if fused:
        R, S, in_ch = embedded.shape
        emb_flat = F.pad(embedded.reshape(R * S, in_ch),
                         (0, pad_lanes(in_ch) - in_ch))
        packed = pack_mlp_weights(net)
        if torch.is_grad_enabled():
            raw = MLPCore.apply(emb_flat, *packed)
        else:
            raw = mlp_fwd(emb_flat, cast_mlp_weights(packed))
        raw = raw.reshape(R, S, OUT_PAD)[..., :4]
    else:
        raw = net(embedded)
    return _apply_removal_edit(raw, stage1["rigidity"], edit)


def query_points(model, cfg: ModelConfig, pts, latents,
                 edit: EditConfig = EditConfig(), network: str = "coarse",
                 detailed: bool = False):
    """Both stages at pts (R, S, 3) with per-ray latents (R, L): raw
    (R, S, 4), or (raw, details) with `detailed`."""
    fused = use_fused_kernel(cfg, edit, pts.device)
    st = bend_encode_stage(model, cfg, pts, latents, edit, fused, detailed)
    raw = canonical_mlp_stage(model, cfg, network, st, edit, fused)
    return (raw, st["details"]) if detailed else raw


def _apply_removal_edit(raw, rigidity: Optional[torch.Tensor],
                        edit: EditConfig):
    """Test-time foreground removal: zero density where rigidity >=
    threshold (reference: run_nerf_helpers.py:309-311)."""
    if edit.nonrigid_object_removal_threshold is not None \
            and rigidity is not None:
        removal = rigidity[..., 0] >= edit.nonrigid_object_removal_threshold
        density = torch.where(removal, torch.zeros_like(raw[..., 3]),
                              raw[..., 3])
        raw = torch.cat([raw[..., :3], density[..., None]], dim=-1)
    return raw
