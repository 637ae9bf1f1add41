"""NR-NeRF with view-dependent colour in plain PyTorch, float32: the
benchmark's reference for `benchmark/configs/nrnerf_viewdirs.json`.

Written from NeRF's view branch (Mildenhall et al., arXiv 2003.08934) and
NR-NeRF's bent view directions (Tretschk et al., arXiv 2012.12247; the
reference implementation facebookresearch/nonrigid_nerf, options
`use_viewdirs` and `approx_nonrigid_viewdirs`, `run_nerf_helpers.py:
283-304,316-369`). Self-contained: it imports torch alone, nothing of the
program it judges and nothing of `reference/nrnerf.py`, whose networks,
compositing, sampling, losses and Adam it repeats line for line.

Per sample point x with per-ray latent l, the canonical MLP's trunk h (8 x
256, ReLU, the encoded input joined again after layer 4) and its heads:

    x'  = x + mask(x) * offsets(x, l)          bent point (the bender)
    d_i = (x'_i - x'_{i-1}) / (|x'_i - x'_{i-1}| + 1e-6), d_0 = d_1
    sigma = h W_alpha + b_alpha                 density, no activation
    f   = h W_f + b_f                           feature, no activation
    h_v = relu([f, gamma(d)] W_v + b_v)         256 + 27 -> 128
    rgb = h_v W_rgb + b_rgb
    raw = [rgb, sigma]

gamma(d) is d and sin / cos of d at 4 octaves (27 channels), as the points'
encoding at 10 (63 channels). The directions are taken along the BENT ray,
as backward differences of consecutive bent samples of one pass in depth
order, the first sample's difference duplicated: the coarse pass on its 64
samples, the fine pass on the sorted union of its 128. They are not
detached: the photometric loss reaches the bender through them too. Inside
`directions_cut()` they are (their values unchanged), which gives the
comparison the gradient without that term.

It follows the reference's own order of work: every pass bends and encodes
all of its sample points, and the fine pass queries the SORTED union of
coarse and importance depths. The divergence of the offsets is taken as
e^T (J^T e), J^T e by a reverse-mode product built into the graph.

Departures from the published description: none in the mathematics. It
implements only what the configuration uses: approximate bent directions
with a bender that has a rigidity network (straight directions without a
bender), ReLU bending, the positional encoding, importance sampling, and no
time-conditioned input (`check_supported` refuses the rest).

Weights are a dict of f32 tensors under the names of `benchmark/harness/
inputs_views.py:weight_shapes` (the program's state_dict names); `cfg` is
the "model" dict of a configuration file. The caller switches TF32 off
(`full_f32`).
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, Optional

import torch
import torch.nn.functional as F

Weights = Dict[str, torch.Tensor]


@contextlib.contextmanager
def full_f32():
    """Matrix products in full float32 (TF32 off) inside the block."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# the precision of the control: the nearest below the one stated
BELOW = {torch.float32: torch.bfloat16, torch.bfloat16: torch.float8_e4m3fn}


def mlp_dtype(config: dict, control: bool = False) -> torch.dtype:
    """The canonical MLP's product precision that a configuration file
    states (its "precision" group), or with `control` the nearest below it
    (bf16 -> fp8: e4m3 operands forward, e5m2 gradients backward)."""
    stated = getattr(torch, config["precision"]["canonical_mlp"])
    return BELOW[stated] if control else stated


# ---------------------------------------------------------------- networks

def fourier(x: torch.Tensor, n_freqs: int) -> torch.Tensor:
    """[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)],
    each sin / cos group over the three coordinates."""
    parts = [x]
    for k in range(n_freqs):
        parts += [torch.sin(x * 2.0 ** k), torch.cos(x * 2.0 ** k)]
    return torch.cat(parts, -1)


def rounded(t: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """t rounded to `dtype`, back in f32; float8 under a per-tensor scale
    that maps t's largest magnitude to the format's largest."""
    if dtype == torch.bfloat16:
        return t.to(dtype).float()
    scale = torch.finfo(dtype).max / torch.clamp(t.detach().abs().max(),
                                                 min=1e-30)
    return (t * scale).to(dtype).float() / scale


class RoundedDense(torch.autograd.Function):
    """x @ w^T + b whose products take operands rounded to a lower
    precision (`rounded`) and sum in f32: an fp8 GEMM in the usual hybrid
    recipe (e4m3 operands forward, the incoming gradient in e5m2 backward),
    or a bf16 GEMM (bf16 both ways)."""

    @staticmethod
    def forward(ctx, x, w, b, dtype):
        xq, wq = rounded(x, dtype), rounded(w, dtype)
        ctx.save_for_backward(xq, wq)
        ctx.grad_dtype = torch.float8_e5m2 if dtype == torch.float8_e4m3fn \
            else dtype
        return F.linear(xq, wq, b)

    @staticmethod
    def backward(ctx, dy):
        xq, wq = ctx.saved_tensors
        dyq = rounded(dy, ctx.grad_dtype)
        dx = dyq @ wq
        dw = dyq.reshape(-1, dyq.shape[-1]).t() @ xq.reshape(-1, xq.shape[-1])
        return dx, dw, dy.reshape(-1, dy.shape[-1]).sum(0), None


def dense(x, w, b, mlp_dtype: Optional[torch.dtype] = None):
    """x @ w^T + b in f32, or as `RoundedDense` in `mlp_dtype` (the
    canonical MLP of a lower-precision control)."""
    return F.linear(x, w, b) if mlp_dtype in (None, torch.float32) \
        else RoundedDense.apply(x, w, b, mlp_dtype)


def canonical_mlp(W: Weights, net: str, cfg: dict, x: torch.Tensor,
                  views: torch.Tensor,
                  mlp_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """raw (..., 4) = [rgb logits, density] of the 8 x 256 trunk on the
    point encoding x (its input joined again after each layer in `skips`)
    with the density and feature heads, and the view layer on [feature,
    views] (the direction encoding) with the rgb head. Every layer,
    the heads included, takes `mlp_dtype`'s products."""
    h = x
    for i in range(cfg["netdepth"]):
        h = torch.relu(dense(h, W[f"{net}.pts.{i}.weight"],
                             W[f"{net}.pts.{i}.bias"], mlp_dtype))
        if i in cfg["skips"]:
            h = torch.cat([x, h], -1)
    sigma = dense(h, W[f"{net}.alpha.weight"], W[f"{net}.alpha.bias"],
                  mlp_dtype)
    feature = dense(h, W[f"{net}.feature.weight"], W[f"{net}.feature.bias"],
                    mlp_dtype)
    h_v = torch.relu(dense(torch.cat([feature, views], -1),
                           W[f"{net}.views.0.weight"],
                           W[f"{net}.views.0.bias"], mlp_dtype))
    rgb = dense(h_v, W[f"{net}.rgb.weight"], W[f"{net}.rgb.bias"], mlp_dtype)
    return torch.cat([rgb, sigma], -1)


def bend(W: Weights, cfg: dict, pts: torch.Tensor, lat: torch.Tensor):
    """(bent points, unmasked offsets, rigidity (..., 1)): the bending MLP
    on [x, latent] (ReLU, an output layer without bias), the rigidity MLP
    on x, mask = (tanh + 1) / 2, bent = x + mask * offsets."""
    h = torch.cat([pts, lat], -1)
    depth = cfg["bending_depth"]
    for i in range(depth - 1):
        h = torch.relu(F.linear(h, W[f"bender.bend.{i}.weight"],
                                W[f"bender.bend.{i}.bias"]))
    offsets = F.linear(h, W[f"bender.bend.{depth - 1}.weight"])
    r = pts
    rdepth = cfg["rigidity_depth"]
    for i in range(rdepth - 1):
        r = torch.relu(F.linear(r, W[f"bender.rigidity.{i}.weight"],
                                W[f"bender.rigidity.{i}.bias"]))
    r = F.linear(r, W[f"bender.rigidity.{rdepth - 1}.weight"],
                 W[f"bender.rigidity.{rdepth - 1}.bias"])
    mask = 0.5 * (torch.tanh(r) + 1.0)
    return pts + mask * offsets, offsets, mask


_CUT = {"directions": False}


@contextlib.contextmanager
def directions_cut():
    """Inside the block the bent-ray directions are cut from the autograd
    graph: the same values, and no gradient through them."""
    _CUT["directions"] = True
    try:
        yield
    finally:
        _CUT["directions"] = False


def bent_ray_dirs(bent: torch.Tensor) -> torch.Tensor:
    """d_i = normalize(x'_i - x'_{i-1}) over a pass's samples (R, S, 3) in
    depth order, the first sample's difference duplicated."""
    diffs = bent[:, 1:] - bent[:, :-1]
    diffs = diffs / (torch.linalg.norm(diffs, dim=-1, keepdim=True) + 1e-6)
    dirs = torch.cat([diffs[:, :1], diffs], 1)
    return dirs.detach() if _CUT["directions"] else dirs


def query(W: Weights, cfg: dict, net: str, pts: torch.Tensor,
          lat: torch.Tensor, rays_d: torch.Tensor,
          mlp_dtype: Optional[torch.dtype] = None):
    """raw (R, S, 4) at pts (R, S, 3), ascending in depth along S, with
    per-ray latents lat (R, L) and directions rays_d (R, 3), and the
    bender's (offsets, mask) or None."""
    lat_pt = lat[:, None, :].expand(pts.shape[:-1] + lat.shape[-1:])
    extra = None
    if cfg["ray_bending"]:
        pts, offsets, mask = bend(W, cfg, pts, lat_pt)
        extra = (offsets, mask)
        dirs = bent_ray_dirs(pts)
    else:
        dirs = (rays_d / torch.linalg.norm(rays_d, dim=-1, keepdim=True)
                )[:, None, :].expand(pts.shape)
    x = fourier(pts, cfg["multires"])
    views = fourier(dirs, cfg["multires_views"])
    return canonical_mlp(W, net, cfg, x, views, mlp_dtype), extra


# ------------------------------------------------------------- rendering

def check_supported(cfg: dict) -> None:
    """Raise ValueError on a configuration this reference does not
    implement (no view directions, exact bent directions, the
    time-conditioned input, SIREN bending, another encoding, fine networks
    of another shape, bending without rigidity, no importance sampling)."""
    unsupported = [
        not cfg["use_viewdirs"],
        cfg["ray_bending"] and not cfg["approx_nonrigid_viewdirs"],
        cfg["time_conditioned_baseline"], cfg["i_embed"] != 0,
        cfg["bending_activation"] != "relu",
        (cfg["netdepth_fine"], cfg["netwidth_fine"])
        != (cfg["netdepth"], cfg["netwidth"]),
        cfg["ray_bending"] and not cfg["use_rigidity_network"],
        cfg["N_importance"] <= 0]
    if any(unsupported):
        raise ValueError("the reference implements NR-NeRF with approximate "
                         "bent view directions, with ReLU bending and "
                         "rigidity, and importance sampling only")


def composite(raw, z, rays_d, noise: Optional[torch.Tensor] = None):
    """Alpha compositing along each ray: (rgb, disparity, depth, acc,
    visibility weights, alpha)."""
    d = torch.cat([z[..., 1:] - z[..., :-1],
                   torch.full_like(z[..., :1], 1e10)], -1)
    d = d * torch.linalg.norm(rays_d, dim=-1, keepdim=True)
    sigma = raw[..., 3] if noise is None else raw[..., 3] + noise
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * d)
    trans = torch.cumprod(1.0 - alpha + 1e-10, -1)
    trans = torch.cat([torch.ones_like(trans[..., :1]), trans[..., :-1]], -1)
    w = alpha * trans
    rgb = (w[..., None] * torch.sigmoid(raw[..., :3])).sum(-2)
    depth = (w * z).sum(-1)
    acc = w.sum(-1)
    disp = 1.0 / torch.clamp(depth / torch.clamp(acc, min=1e-37), min=1e-10)
    return rgb, disp, depth, acc, w, alpha


def importance(bins, weights, u):
    """Inverse-CDF samples at u (R, I) of the piecewise-constant pdf
    `weights` (R, B - 1) over `bins` (R, B); no gradient."""
    weights = weights.detach() + 1e-5
    cdf = torch.cumsum(weights / weights.sum(-1, keepdim=True), -1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], -1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=False)
    lo = torch.clamp(idx - 1, min=0)
    hi = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c_lo, c_hi = cdf.gather(-1, lo), cdf.gather(-1, hi)
    b_lo, b_hi = bins.detach().gather(-1, lo), bins.detach().gather(-1, hi)
    denom = c_hi - c_lo
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b_lo + (u - c_lo) / denom * (b_hi - b_lo)


def render(W: Weights, cfg: dict, rays_o, rays_d, lat, near: float,
           far: float, draws: Optional[dict] = None,
           mlp_dtype: Optional[torch.dtype] = None):
    """Coarse and fine passes over rays (R, 3) with latents (R, L).

    `draws` None: test mode (no jitter, no density noise, evenly spaced
    importance quantiles). Else the dict of `step_draws` sliced to these
    rays: jitter `t_rand`, density noise `noise0` / `noise1` (already
    scaled), quantiles `u`. `mlp_dtype` runs the canonical MLP's products
    in that lower precision (a control). Returns a dict of per-ray maps and
    the coarse pass's internals that the losses read."""
    check_supported(cfg)
    R = rays_o.shape[0]
    S, I = cfg["N_samples"], cfg["N_importance"]
    t = torch.linspace(0.0, 1.0, S, device=rays_o.device)
    z = (near * (1.0 - t) + far * t).expand(R, S)
    if draws is not None:
        mids = 0.5 * (z[..., 1:] + z[..., :-1])
        upper = torch.cat([mids, z[..., -1:]], -1)
        lower = torch.cat([z[..., :1], mids], -1)
        z = lower + (upper - lower) * draws["t_rand"]
    pts = rays_o[:, None] + rays_d[:, None] * z[..., None]
    raw, extra = query(W, cfg, "coarse", pts, lat, rays_d, mlp_dtype)
    rgb0, disp0, _, _, w0, alpha0 = composite(
        raw, z, rays_d, None if draws is None else draws["noise0"])
    u = (torch.linspace(0.0, 1.0, I, device=rays_o.device).expand(R, I)
         if draws is None else draws["u"])
    z_mid = 0.5 * (z[..., 1:] + z[..., :-1])
    z_new = importance(z_mid, w0[..., 1:-1], u)
    z_all = torch.sort(torch.cat([z, z_new], -1), -1).values
    pts_all = rays_o[:, None] + rays_d[:, None] * z_all[..., None]
    raw_all, _ = query(W, cfg, "fine", pts_all, lat, rays_d, mlp_dtype)
    rgb, disp, _, _, _, _ = composite(
        raw_all, z_all, rays_d, None if draws is None else draws["noise1"])
    return {"rgb": rgb, "disp": disp, "rgb0": rgb0, "pts0": pts,
            "weights0": w0, "alpha0": alpha0, "bend0": extra}


def pinhole_rays(c2w, x, y, fx, fy, cx, cy):
    """Rays through pixels (x, y): directions [(x - cx)/fx, -(y - cy)/fy,
    -1] turned by the camera-to-world rotation; origins at its centre."""
    dirs = torch.stack([(x - cx) / fx, -(y - cy) / fy, -torch.ones_like(x)],
                       -1)
    rays_d = (c2w[..., :3, :3] * dirs[..., None, :]).sum(-1)
    return torch.broadcast_to(c2w[..., :3, 3], rays_d.shape), rays_d


@torch.no_grad()
def render_frame(W: Weights, cfg: dict, c2w, H: int, W_px: int, focal: float,
                 lat, near: float, far: float, block: int = 8192,
                 mlp_dtype: Optional[torch.dtype] = None):
    """One H x W frame in test mode, in blocks of rays: (rgb (H, W, 3),
    disparity (H, W))."""
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=c2w.device),
        torch.arange(W_px, dtype=torch.float32, device=c2w.device),
        indexing="ij")
    rays_o, rays_d = pinhole_rays(c2w, xx.reshape(-1), yy.reshape(-1), focal,
                                  focal, W_px / 2.0, H / 2.0)
    rgb, disp = [], []
    for s in range(0, rays_o.shape[0], block):
        n = min(block, rays_o.shape[0] - s)
        out = render(W, cfg, rays_o[s:s + n], rays_d[s:s + n],
                     lat.expand(n, -1), near, far, mlp_dtype=mlp_dtype)
        rgb.append(out["rgb"])
        disp.append(out["disp"])
    return torch.cat(rgb).reshape(H, W_px, 3), torch.cat(disp).reshape(H, W_px)


# -------------------------------------------------------------- training

def step_draws(seed: int, step: int, n_rays: int, cfg: dict, train: dict,
               stack_shape, device) -> dict:
    """The random numbers of training step `step`, drawn from the stream
    seeded with (seed * 1,000,003 + step) mod 2^63, in the order the step
    consumes them: the pixels (image, x, y), the jitter, the coarse
    density noise, the importance quantiles, the fine density noise and
    the divergence probe."""
    g = torch.Generator(device=device).manual_seed(
        (int(seed) * 1_000_003 + int(step)) % (2 ** 63))
    n_img, h, w = stack_shape
    S, I = cfg["N_samples"], cfg["N_importance"]
    out = {"image": torch.randint(0, n_img, (n_rays,), generator=g,
                                  device=device),
           "x": torch.randint(0, w, (n_rays,), generator=g, device=device),
           "y": torch.randint(0, h, (n_rays,), generator=g, device=device),
           "t_rand": torch.rand((n_rays, S), generator=g, device=device)}
    std = train["raw_noise_std"]
    if std > 0.0:
        out["noise0"] = std * torch.randn((n_rays, S), generator=g,
                                          device=device)
    out["u"] = torch.rand((n_rays, I), generator=g, device=device)
    if std > 0.0:
        out["noise1"] = std * torch.randn((n_rays, S + I), generator=g,
                                          device=device)
    if cfg["ray_bending"] and train["divergence_loss_weight"] > 0.0:
        out["e"] = torch.randn((n_rays, S, 3), generator=g, device=device)
    for key in ("noise0", "noise1"):
        out.setdefault(key, None)
    return out


def ray_losses(W: Weights, cfg: dict, train: dict, step: int, rays_o, rays_d,
               target, lat, draws: dict,
               mlp_dtype: Optional[torch.dtype] = None):
    """Per-ray loss (R,): fine and coarse photometric MSE, and for the
    bender the offsets / rigidity and divergence regularizers on the coarse
    samples, both scaled by weight * 0.01^(1 - step / N_iters)."""
    out = render(W, cfg, rays_o, rays_d, lat, train["near"], train["far"],
                 draws, mlp_dtype)
    loss = ((out["rgb"] - target) ** 2).mean(-1) \
        + ((out["rgb0"] - target) ** 2).mean(-1)
    if not cfg["ray_bending"]:
        return loss
    sched = 0.01 ** (1.0 - step / train["N_iters"])
    w_vis = out["weights0"].detach()
    offsets, mask = out["bend0"]
    if train["offsets_loss_weight"] > 0.0:
        norm = torch.linalg.norm(offsets, dim=-1)
        r = mask[..., 0]
        off = (w_vis * torch.clamp(norm, min=1e-9) ** (2.0 - r)).mean(-1) \
            + train["rigidity_loss_weight"] * (w_vis * r).mean(-1)
        loss = loss + train["offsets_loss_weight"] * sched * off
    if train["divergence_loss_weight"] > 0.0:
        p = out["pts0"].detach().requires_grad_(True)
        lat_pt = lat[:, None, :].expand(p.shape[:-1] + lat.shape[-1:])
        _, offsets_at, mask_at = bend(W, cfg, p, lat_pt)
        e = draws["e"]
        jte, = torch.autograd.grad(mask_at * offsets_at, p, grad_outputs=e,
                                   create_graph=True)
        div = (jte * e).sum(-1)
        w_div = 1.0 - torch.exp(-torch.relu(out["alpha0"].detach()))
        loss = loss + train["divergence_loss_weight"] * sched \
            * (w_div * div ** 2).mean(-1)
    return loss


def lr_at(train: dict, count: int) -> float:
    """The learning rate of optimizer step `count`: the reference sets it
    after each step from the step before, so step 0 runs at `lrate`, and
    step k at lrate * 0.1^((k-1) / decay) over 20 (warmup - (k-1)) /
    warmup + 1 while k - 1 < warmup."""
    if count < 1:
        return float(train["lrate"])
    g = float(count - 1)
    lr = train["lrate"] * math.pow(0.1, g / float(train["lrate_decay"]))
    if g < train["warmup_steps"]:
        lr = lr / (20.0 * (train["warmup_steps"] - g) / train["warmup_steps"]
                   + 1.0)
    return lr


def train_steps(W0: Weights, cfg: dict, train: dict, stack: dict, seed: int,
                n_steps: int, n_rays: int, block: int = 2048,
                mlp_dtype: Optional[torch.dtype] = None):
    """`n_steps` Adam steps from the weights W0 on batches of `n_rays`
    pixels of `stack` (images (N, H, W, 3) uint8, poses (N, 3, 4), focal).
    Returns (loss of each step, the first step's gradients, the weights
    after the last step). Gradients are summed over blocks of rays."""
    W = {k: v.detach().clone() for k, v in W0.items()}
    m = {k: torch.zeros_like(v) for k, v in W.items()}
    v2 = {k: torch.zeros_like(v) for k, v in W.items()}
    b1, b2, eps = train["adam_b1"], train["adam_b2"], train["adam_eps"]
    images = stack["images"]
    n_img, h, w = images.shape[:3]
    losses, first_grads = [], None
    for step in range(n_steps):
        d = step_draws(seed, step, n_rays, cfg, train, (n_img, h, w),
                       images.device)
        target = images[d["image"], d["y"], d["x"]].float() / 255.0
        rays_o, rays_d = pinhole_rays(
            stack["poses"][d["image"]], d["x"].float(), d["y"].float(),
            stack["focal"], stack["focal"], w / 2.0, h / 2.0)
        lat_rows = stack["timestep"][d["image"]]
        grads = {k: torch.zeros_like(v) for k, v in W.items()}
        total = 0.0
        for s in range(0, n_rays, block):
            sl = slice(s, min(s + block, n_rays))
            params = {k: v.detach().requires_grad_(True) for k, v in W.items()}
            lat = params["latents"][lat_rows[sl]]
            blk = {k: (None if v is None else v[sl]) for k, v in d.items()}
            loss = ray_losses(params, cfg, train, step, rays_o[sl],
                              rays_d[sl], target[sl], lat, blk,
                              mlp_dtype).sum() / n_rays
            names = list(params)
            gs = torch.autograd.grad(loss, [params[k] for k in names],
                                     allow_unused=True)
            for k, g in zip(names, gs):
                if g is not None:
                    grads[k] += g
            total += float(loss.detach())
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        lr = lr_at(train, step)
        c1, c2 = 1.0 - b1 ** (step + 1), 1.0 - b2 ** (step + 1)
        with torch.no_grad():
            for k in W:
                m[k] = b1 * m[k] + (1.0 - b1) * grads[k]
                v2[k] = b2 * v2[k] + (1.0 - b2) * grads[k] ** 2
                W[k] = W[k] - lr * (m[k] / c1) / (torch.sqrt(v2[k] / c2) + eps)
        losses.append(total)
    return losses, first_grads, W
