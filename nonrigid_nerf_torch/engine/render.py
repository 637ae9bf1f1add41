"""Volumetric rendering: coarse + fine passes over ray blocks
(counterpart of nonrigid_nerf_tpu/engine/render.py:99-366).

`render_rays` renders one block of rays. The fine pass reuses the coarse
samples' stage-1 results (bend + encode), runs stage 1 on the importance
samples only, runs the fine MLP on the UNSORTED union [coarse..., new...]
(the MLP is pointwise), and sorts only the compact raw outputs by depth for
compositing. Without a gradient that union is one of bent points, which
`mlp_fwd_points` encodes (`query.points_to_mlp_fwd`), or with view
directions `mlpv_fwd_points` with the union's directions
(`query.points_to_mlpv_fwd`). Finite-difference view directions depend on
the sample order, so that fine pass sorts the bent points first and takes
the directions, encodes and runs the MLP in sorted order (without a
gradient the kernel encodes). With `stage1_reuse=False` the depths are
sorted first and all of them queried again, as the reference does.
`make_ray_renderer` streams any number of rays through `render_rays` in
fixed `chunk`-sized blocks.
"""

from __future__ import annotations

from typing import Mapping, Optional

import torch

from nonrigid_nerf_torch.config import EditConfig, ModelConfig, RenderSettings
from nonrigid_nerf_torch.device import DeviceLike, resolve_device
from nonrigid_nerf_torch.engine.query import (bend_encode_stage,
                                              canonical_mlp_stage,
                                              embed_for_mlp,
                                              points_to_mlp_fwd,
                                              points_to_mlpv_fwd, query_points,
                                              sample_viewdirs,
                                              use_fused_kernel, views_for_mlp)
from nonrigid_nerf_torch.models.nerf import check_nerf_supported
from nonrigid_nerf_torch.ops.compositing import raw2outputs
from nonrigid_nerf_torch.ops.sampling import sample_pdf, stratified_z_vals
from nonrigid_nerf_torch.utils.spans import span, spanned


DRAW_KEYS = ("t_rand", "noise0", "u", "noise1")


@spanned("sort")
def sort_merge(z, *payloads):
    """Sort z (R, S) ascending and permute every payload (R, S, C) alike.
    Stable, so equal depths keep their [coarse..., new...] order, as in the
    JAX variadic sort. Returns (z_sorted, *sorted_payloads)."""
    z_sorted, perm = torch.sort(z, dim=-1, stable=True)
    return (z_sorted,) + tuple(
        torch.gather(p, -2, perm[..., None].expand(perm.shape + (p.shape[-1],)))
        for p in payloads)


def render_rays(model, cfg: ModelConfig, rs: RenderSettings, rays_o, rays_d,
                latents, generator: Optional[torch.Generator] = None,
                edit: EditConfig = EditConfig(), detailed: bool = False,
                retraw: bool = False, fine_detailed: Optional[bool] = None,
                draws: Optional[Mapping[str, torch.Tensor]] = None):
    """Render a block of rays: rays_o, rays_d (R, 3); latents (R, L).

    Stratified jitter, density noise and importance draws (when rs asks for
    them) come from `generator`, or from `draws`: a dict of tensors
    `t_rand` (R, N_samples) uniform, `noise0` (R, N_samples) normal, `u`
    (R, N_importance) uniform, `noise1` (R, N_samples + N_importance)
    normal, in the order of the JAX key split (stratified, coarse noise,
    importance, fine noise). A key that is absent falls back to the
    generator.

    Returns a dict of per-ray outputs: rgb_map, disp_map, acc_map,
    depth_map, and with importance sampling also the coarse rgb0/disp0/acc0
    and z_std. `retraw` adds the last pass's `raw`. `detailed` adds the
    coarse pass's visibility_weights, opacity_alpha and stage-1 details (the
    training losses read them); `fine_detailed` (default: follow `detailed`)
    also the fine pass's, under `fine_*` keys."""
    check_nerf_supported(cfg)
    draws = {} if draws is None else draws
    unknown = set(draws) - set(DRAW_KEYS)
    if unknown:
        raise ValueError(f"unknown draws {sorted(unknown)}; known: {DRAW_KEYS}")
    R = rays_o.shape[0]
    viewdirs = None
    if cfg.use_viewdirs:
        viewdirs = rays_d / torch.linalg.vector_norm(rays_d, dim=-1,
                                                     keepdim=True)
    fused = use_fused_kernel(cfg, edit, rays_o.device)
    reuse = cfg.stage1_reuse
    # finite-difference directions of bent rays depend on the sample ORDER:
    # that fine pass sorts bent points before the MLP instead of sorting raw
    # outputs after it
    fd_nonrigid = (cfg.use_viewdirs and cfg.approx_nonrigid_viewdirs
                   and model.bender is not None and not edit.render_canonical)
    fine_detailed = detailed if fine_detailed is None \
        else (fine_detailed and detailed)

    z_vals = stratified_z_vals(rs.near, rs.far, R, rs.N_samples,
                               lindisp=rs.lindisp, perturb=rs.perturb,
                               generator=generator, t_rand=draws.get("t_rand"),
                               dtype=rays_o.dtype, device=rays_o.device)
    pts = rays_o[:, None, :] + rays_d[:, None, :] * z_vals[..., None]
    if reuse:
        st = bend_encode_stage(model, cfg, pts, latents, edit, fused, detailed)
        dirs_coarse = ev_coarse = None
        if cfg.use_viewdirs:
            # the coarse depths ascend by construction, so the
            # finite-difference variant holds on the coarse bent points
            with span("viewdirs"):
                dirs_coarse = sample_viewdirs(model, cfg, pts, st, viewdirs,
                                              edit)
                ev_coarse = views_for_mlp(cfg, dirs_coarse, fused)
        raw = canonical_mlp_stage(model, cfg, "coarse", st, ev_coarse, edit,
                                  fused)
        details = st["details"]
    else:
        out = query_points(model, cfg, pts, viewdirs, latents, edit, "coarse",
                           detailed)
        raw, details = out if detailed else (out, None)
    with span("composite"):
        coarse = raw2outputs(raw, z_vals, rays_d, rs.raw_noise_std,
                             rs.white_bkgd, generator=generator,
                             noise=draws.get("noise0"))

    if rs.N_importance > 0:
        with span("importance"):
            z_mid = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
            z_samples = sample_pdf(z_mid,
                                   coarse.visibility_weights[..., 1:-1],
                                   rs.N_importance, det=(rs.perturb == 0.0),
                                   generator=generator, u=draws.get("u"))
        z_cat = torch.cat([z_vals, z_samples], -1)
        fine_details = None
        if reuse:
            # stage 1 runs on the new samples only (without the encoding
            # where it is made after the sort, below)
            pts_new = rays_o[:, None, :] + rays_d[:, None, :] * z_samples[..., None]
            st_new = bend_encode_stage(model, cfg, pts_new, latents, edit,
                                       fused, fine_detailed,
                                       embed=not fd_nonrigid)

            def cat(a, b):
                return torch.cat([a, b], dim=-2)

            with span("union"):
                # the per-ray latents for every sample of the union: the
                # time-conditioned baseline's fine MLP reads them
                latents_cat = (latents[:, None, :].expand(
                    z_cat.shape + (latents.shape[-1],))
                    if st["latents_per_pt"] is not None else None)
                bent_cat = cat(st["bent_pts"], st_new["bent_pts"])
                rigidity_cat = (cat(st["rigidity"], st_new["rigidity"])
                                if st["rigidity"] is not None else None)
                keys = sorted(st_new["details"]) if fine_detailed else []
                det_cat = [cat(details[k], st_new["details"][k])
                           for k in keys]

            if fd_nonrigid:
                # the SORT comes first: bent points, rigidity and any detail
                # channels ride it; directions, encoding and the MLP then
                # run in sorted order and raw needs no further permutation.
                # The coarse samples are still bent only once.
                payloads = [bent_cat] + (
                    [rigidity_cat] if rigidity_cat is not None else [])
                merged = sort_merge(z_cat, *payloads, *det_cat)
                z_all, bent_sorted = merged[0], merged[1]
                rest = list(merged[2:])
                rigidity_sorted = rest.pop(0) if rigidity_cat is not None \
                    else None
                if fine_detailed:
                    fine_details = dict(zip(keys, rest))
                if points_to_mlpv_fwd(cfg, fused):   # the kernel encodes
                    embedded = bent_sorted
                else:
                    with span("stage1"):    # the encoding, in sorted order
                        embedded = embed_for_mlp(cfg, bent_sorted, fused)
                st_sorted = {"embedded": embedded, "bent_pts": bent_sorted,
                             "rigidity": rigidity_sorted,
                             "latents_per_pt": latents_cat}
                with span("viewdirs"):
                    ev_sorted = views_for_mlp(cfg, sample_viewdirs(
                        model, cfg, bent_sorted, st_sorted, viewdirs, edit),
                        fused)
                raw_fine = canonical_mlp_stage(model, cfg, "fine", st_sorted,
                                               ev_sorted, edit, fused)
            else:
                # the fine MLP runs on the UNSORTED union [coarse..., new...]
                # (it is pointwise, and exact or straight view directions
                # are per point), and only its compact outputs (and the
                # detail channels, when asked for) are sorted by depth for
                # compositing
                ev_cat = None
                if cfg.use_viewdirs:
                    with span("viewdirs"):
                        dirs_new = sample_viewdirs(model, cfg, pts_new, st_new,
                                                   viewdirs, edit)
                        ev_cat = views_for_mlp(cfg, cat(dirs_coarse, dirs_new),
                                               fused)
                with span("union"):
                    # on the points routes stage 2 reads the bent points
                    emb_cat = (bent_cat if points_to_mlp_fwd(cfg, fused)
                               or points_to_mlpv_fwd(cfg, fused)
                               else cat(st["embedded"], st_new["embedded"]))
                    st_cat = {"embedded": emb_cat,
                              "bent_pts": bent_cat, "rigidity": rigidity_cat,
                              "latents_per_pt": latents_cat}
                raw_cat = canonical_mlp_stage(model, cfg, "fine", st_cat,
                                              ev_cat, edit, fused)
                merged = sort_merge(z_cat, raw_cat, *det_cat)
                z_all, raw_fine = merged[0], merged[1]
                if fine_detailed:
                    fine_details = dict(zip(keys, merged[2:]))
        else:
            # the reference's way: sort the depths, then bend and encode the
            # coarse samples a second time with the new ones
            with span("sort"):
                z_all = torch.sort(z_cat, dim=-1).values
            pts_fine = rays_o[:, None, :] + rays_d[:, None, :] * z_all[..., None]
            out = query_points(model, cfg, pts_fine, viewdirs, latents, edit,
                               "fine", fine_detailed)
            raw_fine, fine_details = out if fine_detailed else (out, None)
        with span("composite"):
            fine = raw2outputs(raw_fine, z_all, rays_d, rs.raw_noise_std,
                               rs.white_bkgd, generator=generator,
                               noise=draws.get("noise1"))
        ret = dict(rgb_map=fine.rgb_map, disp_map=fine.disp_map,
                   acc_map=fine.acc_map, depth_map=fine.depth_map,
                   rgb0=coarse.rgb_map, disp0=coarse.disp_map,
                   acc0=coarse.acc_map,
                   z_std=torch.std(z_samples, dim=-1, correction=0))
        if retraw:
            ret["raw"] = raw_fine
        if fine_detailed:
            ret["fine_visibility_weights"] = fine.visibility_weights
            ret["fine_opacity_alpha"] = fine.opacity_alpha
            for k, v in fine_details.items():
                ret["fine_" + k] = v
    else:
        ret = dict(rgb_map=coarse.rgb_map, disp_map=coarse.disp_map,
                   acc_map=coarse.acc_map, depth_map=coarse.depth_map)
        if retraw:
            ret["raw"] = raw

    if detailed:
        # coarse-pass internals, read by the offsets and divergence losses
        ret["visibility_weights"] = coarse.visibility_weights
        ret["opacity_alpha"] = coarse.opacity_alpha
        ret.update(details)
    return ret


def make_ray_renderer(cfg: ModelConfig, rs: RenderSettings,
                      edit: EditConfig = EditConfig(), chunk: int = 32768,
                      device: DeviceLike = None, detailed: bool = False,
                      postprocess=None):
    """Build a renderer for any number of rays on `device` (cuda unless
    asked otherwise).

    Rays are padded with copies of the first ray to a multiple of `chunk`
    and rendered block by block without autograd. The stage-2 MLP runs as
    the CUDA kernel under fused_kernel "auto" or "on" on a GPU, and under the
    opt-in modes "pts" and "int8" (the latter on a model that
    `quantize_for_inference` calibrated; see `use_fused_kernel`).

    `postprocess(block_dict) -> dict` runs on each block's outputs, on the
    device, inside the block loop: it reduces the per-sample details of a
    `detailed` block (the correspondence extraction of free-viewpoint
    rendering) to per-ray maps, so that only those are kept and
    concatenated.

    Returns fn(model, rays_o (N, 3), rays_d (N, 3), latents (N, L),
    generator=None) -> dict of (N, ...) tensors; with `detailed` also
    `render_rays`'s per-sample details of both passes."""
    device = resolve_device(device)
    check_nerf_supported(cfg)
    use_fused_kernel(cfg, edit, device)   # raises now on an unsupported mode

    def render(model, rays_o, rays_d, latents,
               generator: Optional[torch.Generator] = None):
        for name, t in (("rays_o", rays_o), ("rays_d", rays_d),
                        ("latents", latents)):
            if t.device != device and not (
                    device.index is None and t.device.type == device.type):
                raise ValueError(f"{name} is on {t.device}, the renderer on "
                                 f"{device}")
        n = rays_o.shape[0]
        n_blocks = max(1, -(-n // chunk))
        pad = n_blocks * chunk - n

        def _pad(x):
            return torch.cat([x, x[:1].expand((pad,) + x.shape[1:])], 0) \
                if pad else x

        ro, rd, lat = _pad(rays_o), _pad(rays_d), _pad(latents)
        outs = []
        with torch.no_grad():
            for b in range(n_blocks):
                with span("block"):
                    sl = slice(b * chunk, (b + 1) * chunk)
                    out = render_rays(model, cfg, rs, ro[sl], rd[sl],
                                      lat[sl], generator=generator,
                                      edit=edit, detailed=detailed)
                    outs.append(postprocess(out) if postprocess is not None
                                else out)
        return {k: torch.cat([o[k] for o in outs], 0)[:n] for k in outs[0]}

    return render
