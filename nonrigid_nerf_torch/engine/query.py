"""The point query: sample points -> (bend) -> encode -> canonical MLP
(counterpart of nonrigid_nerf_tpu/engine/query.py:31-124,127-326).

Stage 1 (`bend_encode_stage`) is network-independent, so the renderer runs
it once per sample point and the fine pass reuses the coarse samples'
results; its bender runs in `cfg.compute_dtype` (bf16: `models/mlp.py:
dense_apply`), in the jvp of exact view directions too. With view
directions, `sample_viewdirs` gives every sample the direction of the BENT
ray there. Stage 2 (`canonical_mlp_stage`) runs the
coarse or fine MLP, as the CUDA kernels when `use_fused_kernel` says so:
`mlp_fwd` on points (`mlp_fwd_points`; with view directions `mlpv_fwd` on
points and directions, `mlpv_fwd_points`) alone where no gradient is
recorded (rendering), and the autograd function `MLPCore` (`MLPVCore`),
whose backward is `mlp_bwd` (`mlpv_bwd`), where one is (training).

For the time-conditioned baseline (no bender) stage 1 hands each sample
its ray's latent, and stage 2 concatenates it to the encoding: the kernels
then run at a 128-lane input, the plain path takes it through `NeRF`.

Where no gradient is recorded under "auto" or "on" (rendering), stage 1
hands over the bent points in place of the encoding. Without view
directions stage 2 hands them with the rays' latents to `mlp_fwd_points`,
which builds the same bf16 encoding (and the baseline's latent lanes) in the
kernel, bit for bit (`points_to_mlp_fwd`); with view directions it hands
them with each sample's direction to `mlpv_fwd_points`, which builds both
encodings in the kernel, bit for bit (`points_to_mlpv_fwd`).

Two opt-in modes of `fused_kernel` take other kernels. "pts": stage 1 hands
over the f32 bent points in place of the encoding, and `mlpe_fwd` /
`MLPECore` compute the encoding on the chip, so no encoding tensor lies
between the stages (`encode_in_kernel`). "int8": `mlp_i8` on the calibration
state that `quantize_for_inference` left in the model; rendering only.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call, jvp

from nonrigid_nerf_torch.config import EditConfig, ModelConfig
from nonrigid_nerf_torch.models.mlp import compute_dtype_of
from nonrigid_nerf_torch.ops.embedding import fourier_embed
from nonrigid_nerf_torch.ops.kernels.mlp_bwd import MLPCore
from nonrigid_nerf_torch.ops.kernels.mlp_fwd import (
    OUT_PAD, cast_mlp_weights, mlp_fwd_points, pack_mlp_weights, pad_lanes)
from nonrigid_nerf_torch.ops.kernels.mlpe_bwd import MLPECore
from nonrigid_nerf_torch.ops.kernels.mlpe_fwd import MULTIRES, mlpe_fwd
from nonrigid_nerf_torch.ops.kernels.mlpv_bwd import MLPVCore
from nonrigid_nerf_torch.ops.kernels.mlpv_fwd import (
    VEMB, cast_mlpv_weights, mlpv_fwd_points, pack_viewdirs_mlp_weights)
from nonrigid_nerf_torch.ops.kernels.quant_mlp import (mlp_i8,
                                                       packed_int8_weights)
from nonrigid_nerf_torch.ops.math import safe_norm
from nonrigid_nerf_torch.utils.spans import span, spanned

FUSED_KERNEL_MODES = ("auto", "on", "off", "pts", "int8")


def supports_fused_query(cfg: ModelConfig) -> bool:
    """Whether the kernels cover this canonical MLP: 8 x 256 with the skip
    at 4 for both networks and the 63-channel encoding; with view directions
    the 27-channel view encoding (`mlpv_fwd`, `mlpv_bwd`), else the single
    head (`mlp_fwd`, `mlp_bwd`). The time-conditioned baseline's input, the
    encoding and the latent, takes the single head at 128 lanes, so without
    view directions and with at most 65 latent channels."""
    return ((not cfg.use_viewdirs or cfg.multires_views == 4)
            and (not cfg.time_conditioned_baseline
                 or (not cfg.use_viewdirs
                     and cfg.input_ch + cfg.ray_bending_latent_size <= 128))
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


def encode_in_kernel(cfg: ModelConfig) -> bool:
    """Whether the fused path computes the Fourier encoding INSIDE the MLP
    kernel: stage 1 then hands over the raw bent points, 3 f32 per point in
    place of 63 encoding channels, in both directions of the hop between the
    stages. Opt-in (`fused_kernel="pts"`); the kernel computes the 10-octave
    encoding of the single-head MLP and nothing else."""
    return (cfg.fused_kernel == "pts" and not cfg.use_viewdirs
            and not cfg.time_conditioned_baseline
            and cfg.i_embed == 0 and cfg.multires == MULTIRES)


def points_to_mlp_fwd(cfg: ModelConfig, fused: bool) -> bool:
    """Whether stage 1 hands stage 2 the bent points for `mlp_fwd_points`
    in place of the encoding: on the kernel path (`fused`) under "auto" or
    "on", where no gradient is recorded and without view directions. The
    kernel then builds the encoding that `embed_for_mlp` would give (and the
    time-conditioned baseline's latent lanes) bit for bit, so the output is
    the encoding route's. Training, "pts", "int8" and view directions keep
    their routes."""
    return (fused and cfg.fused_kernel in ("auto", "on")
            and not cfg.use_viewdirs and not torch.is_grad_enabled())


def points_to_mlpv_fwd(cfg: ModelConfig, fused: bool) -> bool:
    """Whether stage 1 hands stage 2 the bent points, and the view step the
    samples' directions, for `mlpv_fwd_points` in place of the two
    encodings: on the kernel path (`fused`) under "auto" or "on", where no
    gradient is recorded and with view directions. The kernel then builds
    the encodings that `embed_for_mlp` and `_embed_views` would give bit for
    bit, so the output is the encoding route's. Training (`MLPVCore`) and
    scene edits keep their routes ("pts" and "int8" take no view
    directions)."""
    return (fused and cfg.fused_kernel in ("auto", "on")
            and cfg.use_viewdirs and not torch.is_grad_enabled())


def use_fused_kernel(cfg: ModelConfig, edit: EditConfig,
                     device: torch.device) -> bool:
    """Whether stage 2 runs through the kernels' wrappers.

    "off": never. "on": always, and an error where the configuration or a
    scene edit is outside the kernel's support (on a CPU device the wrappers
    run their plain versions). "pts": as "on", with the encoding computed in
    the kernel; also an error with view directions, which that kernel does
    not take. "auto": on a CUDA device whenever "on" would be allowed; a
    scene edit turns it off. "int8": inference only; the int8 kernel covers
    the single-head MLP on the 63-channel encoding, and anything outside that
    (view directions, the time-conditioned input, another architecture, a
    scene edit) takes the plain f32 MLP without an error."""
    mode = cfg.fused_kernel
    if mode not in FUSED_KERNEL_MODES:
        raise ValueError(f"unknown fused_kernel={mode!r}; known: "
                         f"{FUSED_KERNEL_MODES}")
    if mode == "off":
        return False
    supported = supports_fused_query(cfg) and not edits_active(edit)
    if mode == "int8":
        return (supported and not cfg.use_viewdirs
                and not cfg.time_conditioned_baseline)
    if not supported or (mode == "pts" and not encode_in_kernel(cfg)):
        if mode in ("on", "pts"):
            raise ValueError(
                f"fused_kernel={mode!r} but the configuration (architecture, "
                "viewdirs, or scene edits) is outside the kernel's support; "
                "use fused_kernel='auto'")
        return False
    return mode in ("on", "pts") or torch.device(device).type == "cuda"


def _embed_views(cfg: ModelConfig, dirs):
    return dirs if cfg.i_embed == -1 else fourier_embed(dirs,
                                                        cfg.multires_views)


def views_for_mlp(cfg: ModelConfig, dirs, fused: bool):
    """The samples' view directions (R, S, 3) as stage 2 reads them: on
    `points_to_mlpv_fwd`'s route as they are (the kernel encodes them), else
    their encoding (`_embed_views`)."""
    return dirs if points_to_mlpv_fwd(cfg, fused) else _embed_views(cfg, dirs)


def _finite_difference_viewdirs(bent_pts, eps: float = 1e-6):
    """Per-sample view directions of the BENT ray: normalized backward
    differences between consecutive bent samples, the first sample's
    duplicated (reference: run_nerf_helpers.py:316-369, "backward" branch).

    `safe_norm`: the fine pass sorts the union of coarse and importance
    depths, which can hold (near-)duplicates, so zero-length differences."""
    diffs = bent_pts[..., 1:, :] - bent_pts[..., :-1, :]        # (R, S-1, 3)
    diffs = diffs / (safe_norm(diffs, dim=-1, keepdim=True) + eps)
    return torch.cat([diffs[..., :1, :], diffs], dim=-2)        # (R, S, 3)


def sample_viewdirs(model, cfg: ModelConfig, pts, stage1, viewdirs,
                    edit: EditConfig = EditConfig()):
    """Per-sample view directions (R, S, 3) for a block of sample points
    pts (R, S, 3) with stage 1's results and the rays' unit directions
    viewdirs (R, 3).

    Along a bent ray the direction differs from the straight ray's
    (reference: run_nerf_helpers.py:316-385). The approximate variant takes
    normalized backward finite differences between consecutive bent samples
    (pts must ascend in depth along axis -2). The exact variant applies the
    bending Jacobian to the straight direction in ONE forward-mode jvp
    through the bender, built inside the autograd graph, so the outer
    backward reaches the bender's parameters and the latents through it; it
    depends on neither the pass nor the order. Without bending, or when the
    canonical volume is rendered, the directions are the straight ray's."""
    if model.bender is None or edit.render_canonical:
        return viewdirs[:, None, :].expand(pts.shape)
    if cfg.approx_nonrigid_viewdirs:
        return _finite_difference_viewdirs(stage1["bent_pts"])
    d = viewdirs[:, None, :].expand(pts.shape)
    bender = model.bender
    params = dict(bender.named_parameters())
    kwargs = dict(rigidity_test_time_cutoff=edit.rigidity_test_time_cutoff,
                  test_time_scaling=edit.test_time_scaling,
                  compute_dtype=compute_dtype_of(cfg.compute_dtype))

    def bend(p):
        return functional_call(bender, params,
                               (p, stage1["latents_per_pt"]), kwargs)[0]

    _, dd = jvp(bend, (pts,), (d,))
    return dd / (safe_norm(dd, dim=-1, keepdim=True) + 1e-6)


def embed_for_mlp(cfg: ModelConfig, bent_pts, fused: bool):
    """The positional encoding of bent points as stage 2 reads it: in f32
    (sin(2^9 x) needs its mantissa), then with `fused` and no gradient being
    recorded cast to bf16 (the kernel reads bf16, so the tensor between the
    stages is half as wide); under autograd it stays f32 and the autograd
    function casts, so the f32 gradient of the encoding comes back
    unrounded."""
    embedded = bent_pts if cfg.i_embed == -1 else fourier_embed(bent_pts,
                                                                 cfg.multires)
    if fused and not torch.is_grad_enabled():
        embedded = embedded.to(torch.bfloat16)
    return embedded


@spanned("stage1")
def bend_encode_stage(model, cfg: ModelConfig, pts, latents,
                      edit: EditConfig = EditConfig(), fused: bool = False,
                      detailed: bool = False, embed: bool = True):
    """Stage 1: deformation field + positional encoding.

    pts (R, S, 3); latents (R, L) per ray. Returns a dict with
    embedded (R, S, input_ch) as `embed_for_mlp` gives it (with `fused` in
    "pts" mode or on `points_to_mlp_fwd`'s or `points_to_mlpv_fwd`'s route:
    the f32 bent points (R, S, 3), which the kernel encodes), or None with
    `embed=False` (for a caller
    that encodes in another sample order),
    bent_pts (R, S, 3), rigidity (R, S, 1) or None, latents_per_pt (R, S, L)
    or None without bending and without the time-conditioned input, and
    details: None, or with `detailed` the
    internals the regularizers read (initial_input_pts and input_pts, both
    detached, and the bender's unmasked_offsets, rigidity_mask,
    masked_offsets)."""
    R, S = pts.shape[:-1]
    details = {"initial_input_pts": pts.detach()} if detailed else None
    rigidity = None
    latents_per_pt = None
    if cfg.use_ray_bending or cfg.time_conditioned_baseline:
        latents_per_pt = latents[:, None, :].expand(R, S, latents.shape[-1])
    if model.bender is not None and not edit.render_canonical:
        bent_pts, bend_details = model.bender(
            pts, latents_per_pt,
            rigidity_test_time_cutoff=edit.rigidity_test_time_cutoff,
            test_time_scaling=edit.test_time_scaling,
            compute_dtype=compute_dtype_of(cfg.compute_dtype))
        rigidity = bend_details.get("rigidity_mask")
        if detailed:
            details.update(bend_details)
    else:
        bent_pts = pts
    if detailed:
        details["input_pts"] = bent_pts.detach()
    if not embed:
        embedded = None
    elif ((fused and encode_in_kernel(cfg)) or points_to_mlp_fwd(cfg, fused)
          or points_to_mlpv_fwd(cfg, fused)):
        # the MLP kernel encodes on the chip: the bent points go over as
        # they are, and no (R, S, 63) encoding is ever written
        embedded = bent_pts
    else:
        embedded = embed_for_mlp(cfg, bent_pts, fused)
    return {"embedded": embedded, "bent_pts": bent_pts, "rigidity": rigidity,
            "latents_per_pt": latents_per_pt, "details": details}


@spanned("stage2")
def canonical_mlp_stage(model, cfg: ModelConfig, network: str, stage1,
                        embedded_views=None, edit: EditConfig = EditConfig(),
                        fused: bool = False):
    """Stage 2: the coarse or fine canonical MLP on stage 1's encoding (in
    "pts" mode and on `points_to_mlp_fwd`'s and `points_to_mlpv_fwd`'s
    routes: on its bent points; for the time-conditioned baseline with its
    latents concatenated, in the encoding's dtype on the kernel path, or, on
    that route, handed to the kernel per ray) and, with view directions, on
    embedded_views (R, S, input_ch_views; on `points_to_mlpv_fwd`'s route
    the directions, R, S, 3), then the foreground-removal edit. Returns raw
    (R, S, 4) f32."""
    embedded = stage1["embedded"]
    latents_per_pt = stage1["latents_per_pt"]
    net = model.network(network)
    if points_to_mlp_fwd(cfg, fused):
        # stage 1 handed over the bent points; every sample of a ray has the
        # ray's latent, so the kernel reads (R, L) and the ray of a point
        R, S, _ = embedded.shape
        latents = (latents_per_pt[:, 0] if cfg.time_conditioned_baseline
                   else None)
        raw = mlp_fwd_points(embedded.reshape(R * S, 3),
                             cast_mlp_weights(pack_mlp_weights(net)),
                             latents, S)
        raw = raw.reshape(R, S, OUT_PAD)[..., :4]
    elif points_to_mlpv_fwd(cfg, fused):
        # stage 1 handed over the bent points, the view step the directions
        R, S, _ = embedded.shape
        raw = mlpv_fwd_points(embedded.reshape(R * S, 3),
                              embedded_views.reshape(R * S, 3),
                              cast_mlpv_weights(pack_viewdirs_mlp_weights(net)))
        raw = raw.reshape(R, S, OUT_PAD)[..., :4]
    elif fused and encode_in_kernel(cfg):
        # stage 1 handed over the raw bent points (see bend_encode_stage)
        R, S, _ = embedded.shape
        pts_flat = embedded.reshape(R * S, 3)
        packed = pack_mlp_weights(net)
        if torch.is_grad_enabled():
            raw = MLPECore.apply(pts_flat, *packed)
        else:
            raw = mlpe_fwd(pts_flat, cast_mlp_weights(packed))
        raw = raw.reshape(R, S, OUT_PAD)[..., :4]
    elif fused:
        if cfg.time_conditioned_baseline:
            # the latent rides in the MLP input (reference:
            # run_nerf_helpers.py:207-209), padded with it to 128 lanes
            embedded = torch.cat([embedded, latents_per_pt.to(embedded.dtype)],
                                 dim=-1)
        R, S, in_ch = embedded.shape
        emb_flat = F.pad(embedded.reshape(R * S, in_ch),
                         (0, pad_lanes(in_ch) - in_ch))
        if cfg.fused_kernel == "int8":
            key = "fine" if network == "fine" and model.fine is not None \
                else "coarse"
            if model.quant is None or key not in model.quant:
                raise ValueError(
                    "fused_kernel='int8' needs calibration state in the "
                    "model; run quantize_for_inference() first")
            raw = mlp_i8(emb_flat, packed_int8_weights(model.quant[key], net))
        elif cfg.use_viewdirs:
            # training: without a gradient the points route is taken
            v_ch = embedded_views.shape[-1]
            embv_flat = F.pad(embedded_views.reshape(R * S, v_ch),
                              (0, VEMB - v_ch))
            raw = MLPVCore.apply(emb_flat, embv_flat,
                                 *pack_viewdirs_mlp_weights(net))
        else:   # training: without a gradient the points route is taken
            raw = MLPCore.apply(emb_flat, *pack_mlp_weights(net))
        raw = raw.reshape(R, S, OUT_PAD)[..., :4]
    else:
        raw = net(embedded, embedded_views,
                  latents_per_pt if cfg.time_conditioned_baseline else None,
                  compute_dtype_of(cfg.compute_dtype))
    return _apply_removal_edit(raw, stage1["rigidity"], edit)


def query_points(model, cfg: ModelConfig, pts, viewdirs, latents,
                 edit: EditConfig = EditConfig(), network: str = "coarse",
                 detailed: bool = False):
    """Both stages at pts (R, S, 3) with the rays' unit directions viewdirs
    (R, 3) (None without view directions) and per-ray latents (R, L): raw
    (R, S, 4), or (raw, details) with `detailed`. With approximate
    view directions pts must ascend in depth along axis -2."""
    fused = use_fused_kernel(cfg, edit, pts.device)
    st = bend_encode_stage(model, cfg, pts, latents, edit, fused, detailed)
    embedded_views = None
    if cfg.use_viewdirs:
        with span("viewdirs"):
            embedded_views = views_for_mlp(
                cfg, sample_viewdirs(model, cfg, pts, st, viewdirs, edit),
                fused)
    raw = canonical_mlp_stage(model, cfg, network, st, embedded_views, edit,
                              fused)
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
