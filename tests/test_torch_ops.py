"""The port's ops against the JAX package's, on the same numpy inputs (CPU).

Deterministic f32 code must agree to 1e-5 (absolute, on values of order
1; the two frameworks order f32 sums and round transcendental functions
differently, which stays well below that). Random draws are made once with
numpy (or with JAX's own key) and handed to both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nonrigid_nerf_torch.ops import compositing as t_comp
from nonrigid_nerf_torch.ops import embedding as t_emb
from nonrigid_nerf_torch.ops import math as t_math
from nonrigid_nerf_torch.ops import rays as t_rays
from nonrigid_nerf_torch.ops import sampling as t_samp
from nonrigid_nerf_tpu.ops import compositing as j_comp
from nonrigid_nerf_tpu.ops import embedding as j_emb
from nonrigid_nerf_tpu.ops import math as j_math
from nonrigid_nerf_tpu.ops import rays as j_rays
from nonrigid_nerf_tpu.ops import sampling as j_samp

TOL = 1e-5


def close(t, j, tol=TOL):
    np.testing.assert_allclose(t.detach().numpy(), np.asarray(j),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("num_freqs", [0, 4, 10])
def test_fourier_embed(num_freqs):
    x = np.random.RandomState(0).uniform(-1.5, 1.5, (5, 7, 3)).astype(np.float32)
    out = t_emb.fourier_embed(torch.from_numpy(x), num_freqs)
    ref = j_emb.fourier_embed(jnp.asarray(x), num_freqs)
    assert out.shape == ref.shape
    # sin(2^9 x) amplifies the f32 rounding of x by 512
    close(out, ref, tol=1e-4)


def test_fourier_embed_channel_order():
    x = torch.tensor([[0.1, 0.2, 0.3]])
    out = t_emb.fourier_embed(x, 2)[0]
    assert torch.equal(out[:3], x[0])
    assert torch.allclose(out[3:6], torch.sin(x[0]))
    assert torch.allclose(out[6:9], torch.cos(x[0]))
    assert torch.allclose(out[9:12], torch.sin(2 * x[0]))
    assert torch.allclose(out[12:15], torch.cos(2 * x[0]))


def _pose(seed):
    rng = np.random.RandomState(seed)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    return np.concatenate([q, rng.randn(3, 1)], 1).astype(np.float32)


def test_pixel_rays_batched_poses():
    rng = np.random.RandomState(1)
    c2w = np.stack([_pose(i) for i in range(6)])
    x = rng.uniform(0, 64, 6).astype(np.float32)
    y = rng.uniform(0, 48, 6).astype(np.float32)
    o, d = t_rays.pixel_rays(torch.from_numpy(c2w), torch.from_numpy(x),
                             torch.from_numpy(y), 50.0, 55.0, 32.0, 24.0)
    jo, jd = j_rays.pixel_rays(jnp.asarray(c2w), jnp.asarray(x),
                               jnp.asarray(y), 50.0, 55.0, 32.0, 24.0)
    close(o, jo)
    close(d, jd)


def test_get_rays():
    intrin = dict(height=12, width=16, focal_x=20.0, focal_y=21.0,
                  center_x=7.5, center_y=6.0)
    c2w = _pose(3)
    o, d = t_rays.get_rays(torch.from_numpy(c2w), intrin)
    jo, jd = j_rays.get_rays(jnp.asarray(c2w), intrin)
    assert o.shape == (12, 16, 3)
    close(o, jo)
    close(d, jd)


@pytest.mark.parametrize("lindisp", [False, True])
def test_stratified_det(lindisp):
    z = t_samp.stratified_z_vals(0.3, 2.5, 4, 16, lindisp=lindisp)
    jz = j_samp.stratified_z_vals(None, 0.3, 2.5, 4, 16, lindisp=lindisp)
    close(z, jz)


def test_stratified_perturbed_given_draws():
    key = jax.random.PRNGKey(3)
    jz = j_samp.stratified_z_vals(key, 0.3, 2.5, 4, 16, perturb=1.0)
    t_rand = np.array(jax.random.uniform(key, (4, 16), dtype=jnp.float32))
    z = t_samp.stratified_z_vals(0.3, 2.5, 4, 16, perturb=1.0,
                                 t_rand=torch.from_numpy(t_rand))
    close(z, jz)


def test_stratified_perturbed_generator_draws_in_bins():
    g = torch.Generator().manual_seed(0)
    z = t_samp.stratified_z_vals(0.0, 1.0, 3, 8, perturb=1.0, generator=g)
    assert torch.all(z[:, 1:] >= z[:, :-1])
    assert z.min() >= 0.0 and z.max() <= 1.0


def _pdf_inputs(seed, n_rays=6, n_bins=17):
    rng = np.random.RandomState(seed)
    bins = np.sort(rng.uniform(0.5, 3.0, (n_rays, n_bins)), -1).astype(np.float32)
    w = rng.uniform(0, 1, (n_rays, n_bins - 1)).astype(np.float32)
    w[:, 3:7] = 0.0              # flat CDF runs: ties and degenerate intervals
    w[0] = 0.0                   # an empty ray: uniform pdf
    return bins, w


def test_sample_pdf_det():
    bins, w = _pdf_inputs(0)
    s = t_samp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 33,
                          det=True)
    js = j_samp.sample_pdf(None, jnp.asarray(bins), jnp.asarray(w), 33,
                           det=True)
    close(s, js)


def test_sample_pdf_given_uniforms():
    bins, w = _pdf_inputs(1)
    key = jax.random.PRNGKey(7)
    js = j_samp.sample_pdf(key, jnp.asarray(bins), jnp.asarray(w), 24)
    u = np.array(jax.random.uniform(key, (6, 24), dtype=jnp.float32))
    s = t_samp.sample_pdf(torch.from_numpy(bins), torch.from_numpy(w), 24,
                          u=torch.from_numpy(u))
    close(s, js)


def test_invert_cdf_tie_rule_matches_jax_reduction():
    """u exactly on cdf entries (0, a repeated entry, 1): the bracket is the
    largest bin with cdf STRICTLY < u, as in the JAX masked reduction."""
    cdf = np.array([[0.0, 0.25, 0.25, 0.5, 1.0]], np.float32)
    bins = np.array([[0.0, 1.0, 2.0, 3.0, 4.0]], np.float32)
    u = np.array([[0.0, 0.25, 0.5, 0.75, 1.0]], np.float32)
    out = t_samp.invert_cdf(torch.from_numpy(cdf), torch.from_numpy(bins),
                            torch.from_numpy(u))
    mask = cdf[..., :, None] < u[..., None, :]
    cb, ca = j_samp._gather_intervals(jnp.asarray(mask), jnp.asarray(cdf))
    bb, ba = j_samp._gather_intervals(jnp.asarray(mask), jnp.asarray(bins))
    denom = np.where(np.asarray(ca - cb) < 1e-5, 1.0, np.asarray(ca - cb))
    ref = np.asarray(bb) + (u - np.asarray(cb)) / denom * np.asarray(ba - bb)
    np.testing.assert_array_equal(out.numpy(), ref)
    # u = 0.25 ties cdf[1] (== cdf[2]): bracket (0, 1) -> exactly bin 1
    assert out[0, 1].item() == 1.0


@pytest.mark.parametrize("noise", [0.0, 1.0])
@pytest.mark.parametrize("white_bkgd", [False, True])
def test_raw2outputs(noise, white_bkgd):
    rng = np.random.RandomState(2)
    raw = rng.randn(5, 12, 4).astype(np.float32) * 2
    z = np.sort(rng.uniform(0.5, 3.0, (5, 12)), -1).astype(np.float32)
    rd = rng.randn(5, 3).astype(np.float32)
    key = jax.random.PRNGKey(5)
    ref = j_comp.raw2outputs(jnp.asarray(raw), jnp.asarray(z), jnp.asarray(rd),
                             raw_noise_std=noise, white_bkgd=white_bkgd,
                             noise_key=key)
    normal = np.array(jax.random.normal(key, (5, 12), dtype=jnp.float32))
    out = t_comp.raw2outputs(torch.from_numpy(raw), torch.from_numpy(z),
                             torch.from_numpy(rd), raw_noise_std=noise,
                             white_bkgd=white_bkgd,
                             noise=torch.from_numpy(normal))
    for name in t_comp.RenderOutputs._fields:
        close(getattr(out, name), getattr(ref, name))


def test_raw2outputs_empty_ray_disp_clamps():
    raw = torch.full((1, 4, 4), -5.0)          # zero density: acc = 0
    z = torch.linspace(1.0, 2.0, 4)[None]
    out = t_comp.raw2outputs(raw, z, torch.ones(1, 3))
    ref = j_comp.raw2outputs(jnp.asarray(raw.numpy()), jnp.asarray(z.numpy()),
                             jnp.ones((1, 3)))
    close(out.disp_map, ref.disp_map)
    assert torch.isfinite(out.disp_map).all()


def test_math_helpers():
    rng = np.random.RandomState(4)
    a = rng.uniform(0, 1, (6, 3)).astype(np.float32)
    b = rng.uniform(0, 1, (6, 3)).astype(np.float32)
    mse = t_math.img2mse(torch.from_numpy(a), torch.from_numpy(b), 6)
    jmse = j_math.img2mse(jnp.asarray(a), jnp.asarray(b), 6)
    close(mse, jmse)
    close(t_math.mse2psnr(mse), j_math.mse2psnr(jmse))
    np.testing.assert_array_equal(t_math.to8b(torch.from_numpy(a * 1.5 - 0.2)),
                                  j_math.to8b(a * 1.5 - 0.2))
    v = torch.tensor([[0.0, 0.0, 0.0], [3.0, 4.0, 0.0]], requires_grad=True)
    n = t_math.safe_norm(v)
    close(n, j_math.safe_norm(jnp.asarray(v.detach().numpy())))
    n.sum().backward()
    assert torch.isfinite(v.grad).all() and torch.all(v.grad[0] == 0)


def test_ndc_rays_matches_jax():
    """API parity (the reference keeps NDC off): rays in front of a camera
    at the origin looking down -z, projected with the package-level export
    of both."""
    import nonrigid_nerf_torch.ops as t_ops
    import nonrigid_nerf_tpu.ops as j_ops
    rng = np.random.RandomState(5)
    o = (0.2 * rng.randn(64, 3)).astype(np.float32)
    d = np.concatenate([0.5 * rng.randn(64, 2), -np.ones((64, 1))],
                       1).astype(np.float32)
    got = t_ops.ndc_rays(48, 64, 50.0, 52.0, 1.0, torch.from_numpy(o),
                         torch.from_numpy(d))
    want = j_ops.ndc_rays(48, 64, 50.0, 52.0, 1.0, jnp.asarray(o),
                          jnp.asarray(d))
    assert t_ops.ndc_rays is t_rays.ndc_rays
    for a, b in zip(got, want):
        assert a.shape == (64, 3)
        close(a, b)
