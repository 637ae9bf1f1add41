"""`mlp_fwd`'s points input (`mlp_fwd_points`) and the render path's route
to it, on the CPU.

- The plain points entry is `mlp_fwd_plain` on the encoding the engine
  builds (`fourier_embed` in f32, the latent lanes at 128, bf16), bit for
  bit.
- The route (`query.points_to_mlp_fwd`): the kernel path under "auto" or
  "on" with no gradient recorded and no view directions; training, "pts",
  "int8", "off" and scene edits keep their routes, and view directions take
  `mlpv_fwd_points` (tests/test_torch_mlpv_fwd_points.py).
- `render_rays` renders the same outputs, bit for bit, on the points route
  and with the encoding route forced.

The kernel itself is held to `mlp_fwd` on the card by
`tests/test_torch_kernels_cuda.py`.
"""

import dataclasses

import pytest
import torch
import torch.nn.functional as F

from nonrigid_nerf_torch.config import EditConfig, ModelConfig, RenderSettings
from nonrigid_nerf_torch.engine import query as t_query
from nonrigid_nerf_torch.engine import render as t_render
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.ops.embedding import fourier_embed
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K

FLAGSHIP = ModelConfig(N_samples=8, N_importance=8, fused_kernel="on")
BASELINE = dataclasses.replace(FLAGSHIP, ray_bending=None,
                               time_conditioned_baseline=True)
RS = RenderSettings(N_samples=8, N_importance=8, near=0.1,
                    far=1.6).test_mode()
CPU = torch.device("cpu")


def _model(cfg, seed=0):
    """A model from a seed with a deforming bender and latents that carry
    signal."""
    gen = torch.Generator().manual_seed(seed)
    m = NRNeRF(cfg, num_timesteps=2, generator=gen, device="cpu")
    with torch.no_grad():
        m.latents.copy_(0.3 * torch.randn(m.latents.shape, generator=gen))
        if m.bender is not None:
            last = m.bender.bend[-1]
            last.weight.copy_(0.05 * torch.randn(last.weight.shape,
                                                 generator=gen))
    return m


def _weights(cfg, seed=0):
    with torch.no_grad():
        return K.cast_mlp_weights(K.pack_mlp_weights(
            _model(cfg, seed).fine))


def _points(n, rays, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return (1.5 * torch.randn(n, 3, generator=gen),
            0.3 * torch.randn(rays, 32, generator=gen))


@pytest.mark.parametrize("width,n,samples", [(64, 100, 1), (128, 96, 8),
                                             (128, 97, 8), (128, 1, 64)])
def test_plain_points_entry_is_mlp_fwd_plain_on_the_encoding(width, n,
                                                             samples):
    mw = _weights(FLAGSHIP if width == 64 else BASELINE)
    assert mw[0].shape == (width, 256)
    pts, lat = _points(n, -(-n // samples))
    lat = lat if width == 128 else None
    emb = fourier_embed(pts, 10)
    if lat is not None:
        emb = torch.cat([emb, lat.repeat_interleave(samples, 0)[:n]], -1)
    emb = F.pad(emb, (0, width - emb.shape[1])).to(torch.bfloat16)
    assert torch.equal(K.points_encoding(pts, width, lat, samples), emb)
    before = (K.mlp_fwd.launches, K.mlp_fwd.points_launches)
    got = K.mlp_fwd_points(pts, mw, lat, samples)
    assert (K.mlp_fwd.launches, K.mlp_fwd.points_launches) == before
    assert got.shape == (n, K.OUT_PAD) and got.dtype == torch.float32
    assert torch.equal(got, K.mlp_fwd_plain(emb, mw))
    assert torch.equal(got, K.mlp_fwd(emb, mw))


def test_points_entry_refuses_what_it_cannot_place():
    mw64, mw128 = _weights(FLAGSHIP), _weights(BASELINE)
    pts, lat = _points(64, 8)
    with pytest.raises(ValueError, match="takes latents"):
        K.mlp_fwd_points(pts, mw128)
    with pytest.raises(ValueError, match="do not fit"):
        K.mlp_fwd_points(pts, mw64, lat, 8)
    with pytest.raises(ValueError, match="do not fit"):
        K.mlp_fwd_points(pts, mw128, torch.zeros(8, 66), 8)
    with pytest.raises(ValueError, match="do not cover"):
        K.mlp_fwd_points(pts, mw128, lat, 7)
    with pytest.raises(ValueError, match="positive"):
        K.mlp_fwd_points(pts, mw128, lat, 0)
    with pytest.raises(ValueError, match=r"\(n, 3\) f32"):
        K.mlp_fwd_points(pts.double(), mw64)
    with pytest.raises(ValueError, match="packed weights"):
        K.mlp_fwd_points(pts, mw64[:18])
    with pytest.raises(ValueError, match="latents must be"):
        K.mlp_fwd_points(pts, mw128, lat.double(), 8)


ROUTES = {
    # name: (cfg, edit, grad, points route, stage 1 hands over points)
    "on": (FLAGSHIP, EditConfig(), False, True, True),
    "auto": (dataclasses.replace(FLAGSHIP, fused_kernel="auto"),
             EditConfig(), False, False, False),   # a CPU device: not fused
    "on-baseline": (BASELINE, EditConfig(), False, True, True),
    "on-training": (FLAGSHIP, EditConfig(), True, False, False),
    # view directions: `mlpv_fwd_points`' route, which takes points too
    "viewdirs": (dataclasses.replace(FLAGSHIP, use_viewdirs=True),
                 EditConfig(), False, False, True),
    "pts": (dataclasses.replace(FLAGSHIP, fused_kernel="pts"), EditConfig(),
            False, False, True),
    "int8": (dataclasses.replace(FLAGSHIP, fused_kernel="int8"),
             EditConfig(), False, False, False),
    "off": (dataclasses.replace(FLAGSHIP, fused_kernel="off"), EditConfig(),
            False, False, False),
    "auto-edit": (dataclasses.replace(FLAGSHIP, fused_kernel="auto"),
                  EditConfig(render_canonical=True), False, False, False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_follows_what_the_code_observes(name):
    """Stage 1 hands over the bent points exactly where the route applies,
    and stage 2 then calls `mlp_fwd_points`; elsewhere stage 1 gives what it
    gave before (the encoding, or the points for "pts"'s `mlpe_fwd` and for
    `mlpv_fwd_points`)."""
    cfg, edit, grad, points, hands_points = ROUTES[name]
    fused = t_query.use_fused_kernel(cfg, edit, CPU)
    model = _model(cfg)
    pts = torch.randn(4, 8, 3, generator=torch.Generator().manual_seed(1))
    lat = model.latents[torch.tensor([0, 1, 0, 1])].detach()
    with torch.set_grad_enabled(grad):
        assert t_query.points_to_mlp_fwd(cfg, fused) == points
        st = t_query.bend_encode_stage(model, cfg, pts, lat, edit, fused)
    if hands_points:
        assert st["embedded"] is st["bent_pts"]
    else:
        assert st["embedded"].shape == (4, 8, 63)
        want = (torch.bfloat16 if fused and not grad else torch.float32)
        assert st["embedded"].dtype == want


def test_route_never_meets_a_scene_edit_under_on():
    """Under "on" a scene edit is refused before any route is chosen."""
    with pytest.raises(ValueError, match="outside the kernel's support"):
        t_query.use_fused_kernel(FLAGSHIP, EditConfig(render_canonical=True),
                                 CPU)


CASES = {
    "flagship": FLAGSHIP,
    "baseline": BASELINE,
    "flagship-requery": dataclasses.replace(FLAGSHIP, stage1_reuse=False),
    "baseline-requery": dataclasses.replace(BASELINE, stage1_reuse=False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_rays_unchanged_between_the_routes(case, monkeypatch):
    """Both passes of `render_rays` without a gradient: the points route
    (stage 1's bent points, the union of bent points, `mlp_fwd_points`)
    renders every output of the encoding route bit for bit."""
    cfg = CASES[case]
    model = _model(cfg, 3)
    gen = torch.Generator().manual_seed(4)
    ro = torch.tensor([[0.0, 0.0, 0.6]]).repeat(6, 1)
    rd = torch.cat([0.8 * torch.rand(6, 2, generator=gen) - 0.4,
                    -torch.ones(6, 1)], 1)
    lat = model.latents[torch.arange(6) % 2].detach()
    calls = []
    real = t_query.mlp_fwd_points
    monkeypatch.setattr(t_query, "mlp_fwd_points", lambda *a: (
        calls.append(a[0].shape[0]) or real(*a)))
    with torch.no_grad():
        got = t_render.render_rays(model, cfg, RS, ro, rd, lat, retraw=True,
                                   detailed=True)
        assert calls == [6 * 8, 6 * 16]
        for module in (t_query, t_render):
            monkeypatch.setattr(module, "points_to_mlp_fwd",
                                lambda cfg, fused: False)
        want = t_render.render_rays(model, cfg, RS, ro, rd, lat, retraw=True,
                                    detailed=True)
    assert calls == [6 * 8, 6 * 16]
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
