"""`mlpv_fwd`'s points input (`mlpv_fwd_points`) and the view render path's
route to it, on the CPU.

- The plain points entry is `mlpv_fwd_plain` on the two encodings the
  engine builds (`fourier_embed` in f32, bf16, padded to 64 and 32 lanes),
  bit for bit.
- The route (`query.points_to_mlpv_fwd`): the kernel path under "auto" or
  "on" with view directions and no gradient recorded; training, "off",
  "pts", "int8" and scene edits keep their routes.
- `render_rays` renders the same outputs, bit for bit, on the points route
  and with the encoding route forced: the coarse pass, the sort-first fine
  pass of finite-difference directions, the unsorted union of exact or
  straight directions, and `stage1_reuse=False`.

The kernel itself is held to `mlpv_fwd` on the card by
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
from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as KV

VIEWS = ModelConfig(N_samples=8, N_importance=8, fused_kernel="on",
                    use_viewdirs=True)
RS = RenderSettings(N_samples=8, N_importance=8, near=0.1,
                    far=1.6).test_mode()
CPU = torch.device("cpu")
CUDA = torch.device("cuda")     # a device object only: nothing runs there


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


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


@pytest.fixture(scope="module")
def weights():
    with torch.no_grad():
        return KV.cast_mlpv_weights(KV.pack_viewdirs_mlp_weights(
            _model(VIEWS).fine))


def _inputs(n, seed=0):
    gen = torch.Generator().manual_seed(seed)
    dirs = torch.randn(n, 3, generator=gen)
    return (1.5 * torch.randn(n, 3, generator=gen),
            dirs / torch.linalg.vector_norm(dirs, dim=-1, keepdim=True))


@pytest.mark.parametrize("n", [1, 97, 130])
def test_plain_points_entry_is_mlpv_fwd_plain_on_the_encodings(weights, n):
    pts, dirs = _inputs(n, n)
    emb = F.pad(fourier_embed(pts, 10).to(torch.bfloat16), (0, 1))
    embv = F.pad(fourier_embed(dirs, 4).to(torch.bfloat16), (0, 5))
    assert torch.equal(KV.views_encoding(dirs), embv)
    before = (KV.mlpv_fwd.launches, KV.mlpv_fwd.points_launches)
    got = KV.mlpv_fwd_points(pts, dirs, weights)
    assert (KV.mlpv_fwd.launches, KV.mlpv_fwd.points_launches) == before
    assert got.shape == (n, KV.OUT_PAD) and got.dtype == torch.float32
    assert torch.equal(got, KV.mlpv_fwd_plain(emb, embv, weights))
    assert torch.equal(got, KV.mlpv_fwd(emb, embv, weights))


def test_points_entry_refuses_what_it_cannot_take(weights):
    pts, dirs = _inputs(8)
    with pytest.raises(ValueError, match=r"pts must be \(n, 3\) f32"):
        KV.mlpv_fwd_points(pts.double(), dirs, weights)
    with pytest.raises(ValueError, match=r"pts must be \(n, 3\) f32"):
        KV.mlpv_fwd_points(pts[:, :2], dirs, weights)
    with pytest.raises(ValueError, match=r"dirs must be \(n, 3\) f32"):
        KV.mlpv_fwd_points(pts, dirs.half(), weights)
    with pytest.raises(ValueError, match=r"dirs must be \(8, 3\)"):
        KV.mlpv_fwd_points(pts, dirs[:7], weights)
    with pytest.raises(ValueError, match="packed weights"):
        KV.mlpv_fwd_points(pts, dirs, weights[:25])
    with pytest.raises(ValueError, match="packed weight 1 must be"):
        KV.mlpv_fwd_points(pts, dirs, (weights[0], weights[1].double(),
                                       *weights[2:]))


ROUTES = {
    # name: (cfg, edit, device, grad, fused where use_fused_kernel refuses
    # the mode, points route)
    "on": (VIEWS, EditConfig(), CPU, False, None, True),
    "auto-cuda": (dataclasses.replace(VIEWS, fused_kernel="auto"),
                  EditConfig(), CUDA, False, None, True),
    "auto-cpu": (dataclasses.replace(VIEWS, fused_kernel="auto"),
                 EditConfig(), CPU, False, None, False),
    "on-training": (VIEWS, EditConfig(), CPU, True, None, False),
    "off": (dataclasses.replace(VIEWS, fused_kernel="off"), EditConfig(),
            CPU, False, None, False),
    "pts": (dataclasses.replace(VIEWS, fused_kernel="pts"), EditConfig(),
            CPU, False, True, False),
    "int8": (dataclasses.replace(VIEWS, fused_kernel="int8"), EditConfig(),
             CUDA, False, None, False),
    "auto-edit": (dataclasses.replace(VIEWS, fused_kernel="auto"),
                  EditConfig(render_canonical=True), CUDA, False, None,
                  False),
    "no-viewdirs": (dataclasses.replace(VIEWS, use_viewdirs=False),
                    EditConfig(), CPU, False, None, False),
}


@pytest.mark.parametrize("name", sorted(ROUTES))
def test_route_follows_what_the_code_observes(name):
    """`points_to_mlpv_fwd` holds exactly where the kernel path renders a
    view-direction model: "on", or "auto" on a CUDA device, no gradient, no
    scene edit. "pts" is refused with view directions (`use_fused_kernel`
    raises) and is off the route even where it would be fused."""
    cfg, edit, device, grad, fused, points = ROUTES[name]
    if fused is None:
        fused = t_query.use_fused_kernel(cfg, edit, device)
    else:
        with pytest.raises(ValueError, match="outside the kernel's support"):
            t_query.use_fused_kernel(cfg, edit, device)
    with torch.set_grad_enabled(grad):
        assert t_query.points_to_mlpv_fwd(cfg, fused) == points
        assert not (points and t_query.points_to_mlp_fwd(cfg, fused))


def test_stage1_hands_over_the_bent_points_on_the_route():
    """Stage 1 on the route hands over the bent points; under autograd the
    f32 encoding, as before."""
    model = _model(VIEWS)
    pts = torch.randn(4, 8, 3, generator=torch.Generator().manual_seed(1))
    lat = model.latents[torch.tensor([0, 1, 0, 1])].detach()
    with torch.no_grad():
        st = t_query.bend_encode_stage(model, VIEWS, pts, lat, fused=True)
        assert st["embedded"] is st["bent_pts"]
        dirs = torch.randn(4, 8, 3)
        assert t_query.views_for_mlp(VIEWS, dirs, True) is dirs
    st = t_query.bend_encode_stage(model, VIEWS, pts, lat, fused=True)
    assert st["embedded"].shape == (4, 8, 63)
    assert st["embedded"].dtype == torch.float32
    assert t_query.views_for_mlp(VIEWS, dirs, True).shape == (4, 8, 27)


CASES = {
    # name: (cfg, mlpv_fwd_points calls as points a call)
    "fd": (VIEWS, [6 * 8, 6 * 16]),             # coarse, sort-first fine
    "exact": (dataclasses.replace(VIEWS, approx_nonrigid_viewdirs=False),
              [6 * 8, 6 * 16]),                 # coarse, unsorted union
    "straight": (dataclasses.replace(VIEWS, ray_bending=None),
                 [6 * 8, 6 * 16]),              # no bender: the rays' own
    "fd-requery": (dataclasses.replace(VIEWS, stage1_reuse=False),
                   [6 * 8, 6 * 16]),            # `query_points` twice
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_render_rays_unchanged_between_the_routes(case, monkeypatch):
    """Both passes of `render_rays` without a gradient: the points route
    (stage 1's bent points and the samples' directions, the union of both,
    `mlpv_fwd_points`) renders every output of the encoding route bit for
    bit."""
    cfg, want_calls = CASES[case]
    model = _model(cfg, 3)
    gen = torch.Generator().manual_seed(4)
    ro = torch.tensor([[0.0, 0.0, 0.6]]).repeat(6, 1)
    rd = torch.cat([0.8 * torch.rand(6, 2, generator=gen) - 0.4,
                    -torch.ones(6, 1)], 1)
    lat = model.latents[torch.arange(6) % 2].detach()
    calls = []
    real = t_query.mlpv_fwd_points
    monkeypatch.setattr(t_query, "mlpv_fwd_points", lambda *a: (
        calls.append((a[0].shape[0], a[1].shape[0])) or real(*a)))
    with torch.no_grad():
        got = t_render.render_rays(model, cfg, RS, ro, rd, lat, retraw=True,
                                   detailed=True)
        assert calls == [(n, n) for n in want_calls]
        for module in (t_query, t_render):
            monkeypatch.setattr(module, "points_to_mlpv_fwd",
                                lambda cfg, fused: False)
        want = t_render.render_rays(model, cfg, RS, ro, rd, lat, retraw=True,
                                    detailed=True)
    assert len(calls) == len(want_calls)
    assert sorted(got) == sorted(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
