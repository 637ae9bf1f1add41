"""The port's CUDA kernels on the card, against their plain versions.

These tests need an NVIDIA GPU and skip without one. They import neither
JAX nor the JAX package (the GPU machine has no JAX), and the repository's
conftest imports JAX, so run them there with

    python -m pytest tests/test_torch_kernels_cuda.py -q -p no:cacheprovider --noconftest

from the repository root.
"""

import numpy as np
import pytest
import torch

from nonrigid_nerf_torch.config import ModelConfig, RenderSettings
from nonrigid_nerf_torch.engine.render import make_ray_renderer
from nonrigid_nerf_torch.models.model import NRNeRF
from nonrigid_nerf_torch.ops.kernels import bend_bwd as BB
from nonrigid_nerf_torch.ops.kernels import bend_fwd as BF
from nonrigid_nerf_torch.ops.kernels import fused_bwd as FB
from nonrigid_nerf_torch.ops.kernels import fused_fwd as FF
from nonrigid_nerf_torch.ops.kernels import fused_query as FQ
from nonrigid_nerf_torch.ops.kernels import mlp_bwd as KB
from nonrigid_nerf_torch.ops.kernels import mlp_fwd as K
from nonrigid_nerf_torch.ops.kernels import mlpe_bwd as KEB
from nonrigid_nerf_torch.ops.kernels import mlpe_fwd as KE
from nonrigid_nerf_torch.ops.kernels import mlpv_bwd as KVB
from nonrigid_nerf_torch.ops.kernels import mlpv_fwd as KV
from nonrigid_nerf_torch.ops.kernels import quant_mlp as KQ

CFG = ModelConfig()          # the flagship: 8 x 256 coarse and fine, bending
CFG_V = ModelConfig(use_viewdirs=True)     # ... with view directions


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def model():
    """The port's model from a seed, with the zero-initialised bending and
    rigidity output layers perturbed so the deformation runs."""
    gen = torch.Generator().manual_seed(0)
    m = NRNeRF(CFG, num_timesteps=1, generator=gen, device="cpu")
    with torch.no_grad():
        for layer, scale in ((m.bender.bend[-1], 0.05),
                             (m.bender.rigidity[-1], 0.3)):
            layer.weight.copy_(scale * torch.randn(layer.weight.shape,
                                                   generator=gen))
        m.latents.copy_(0.1 * torch.randn(m.latents.shape, generator=gen))
        for net in (m.coarse, m.fine):
            net.output.bias[3] += 1.0
    return m


@pytest.fixture(scope="module")
def model_v():
    """The view-direction model from a seed, perturbed like `model`."""
    gen = torch.Generator().manual_seed(1)
    m = NRNeRF(CFG_V, num_timesteps=1, generator=gen, device="cpu")
    with torch.no_grad():
        for layer, scale in ((m.bender.bend[-1], 0.05),
                             (m.bender.rigidity[-1], 0.3)):
            layer.weight.copy_(scale * torch.randn(layer.weight.shape,
                                                   generator=gen))
        m.latents.copy_(0.1 * torch.randn(m.latents.shape, generator=gen))
        for net in (m.coarse, m.fine):
            net.alpha.bias += 1.0
    return m


def _embv(n, seed=0):
    embv = np.random.RandomState(seed).uniform(-1, 1, (n, 32)).astype(np.float32)
    embv[:, 27:] = 0.0        # the pad lanes
    return embv


def _emb(n, seed=0):
    emb = np.random.RandomState(seed).uniform(-1, 1, (n, 64)).astype(np.float32)
    emb[:, 63] = 0.0          # the pad lane
    return emb


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_kernel_matches_plain_on_cuda(model, cuda_device, n):
    mw = tuple(w.detach().to(cuda_device) for w in
               K.cast_mlp_weights(K.pack_mlp_weights(model.coarse)))
    emb = torch.from_numpy(_emb(n, 3)).to(cuda_device)
    before = K.mlp_fwd.launches
    out = K.mlp_fwd(emb, mw)
    torch.cuda.synchronize()
    assert K.mlp_fwd.launches == before + (n > 0)
    assert out.shape == (n, K.OUT_PAD) and out.dtype == torch.float32
    err = (out - K.mlp_fwd_plain(emb, mw)).abs()
    if n:
        assert err.max().item() <= K.BF16_TOL_MAX
        assert err.mean().item() <= K.BF16_TOL_MEAN
    # deterministic: no atomics
    assert torch.equal(out, K.mlp_fwd(emb, mw))


def _assert_bwd_close(got, ref):
    """demb and the 19 gradients within the tolerances `mlp_bwd.py` states."""
    for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        assert a.shape == b.shape and a.dtype == torch.float32
    stats = KB.bwd_agreement(got, ref)
    assert stats["ok"], stats


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_bwd_kernel_matches_plain_on_cuda(model, cuda_device, n):
    mw = tuple(w.detach().to(cuda_device) for w in
               K.cast_mlp_weights(K.pack_mlp_weights(model.fine)))
    embb = torch.from_numpy(_emb(n, 5)).to(cuda_device).to(torch.bfloat16)
    draw = torch.from_numpy(np.random.RandomState(6).randn(n, 8).astype(
        np.float32)).to(cuda_device)
    before = KB.mlp_bwd.launches
    got = KB.mlp_bwd(embb, mw, draw)
    torch.cuda.synchronize()
    assert KB.mlp_bwd.launches == before + (n > 0)
    _assert_bwd_close(got, KB.mlp_bwd_plain(embb, mw, draw))
    # deterministic: fixed-order reduction, no atomics
    again = KB.mlp_bwd(embb, mw, draw)
    assert torch.equal(got[0], again[0])
    for a, b in zip(got[1], again[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_bwd_kernel_refuses_more_points_than_one_launch_takes(
        model, cuda_device, monkeypatch):
    """One call is one launch: more points than its scratch allows raise,
    and nothing is launched or counted."""
    mw = tuple(w.detach().to(cuda_device) for w in
               K.cast_mlp_weights(K.pack_mlp_weights(model.coarse)))
    embb = torch.from_numpy(_emb(700, 7)).to(cuda_device).to(torch.bfloat16)
    draw = torch.from_numpy(np.random.RandomState(8).randn(700, 8).astype(
        np.float32)).to(cuda_device)
    monkeypatch.setattr(KB, "MAX_POINTS_PER_LAUNCH", 256)
    before = KB.mlp_bwd.launches
    with pytest.raises(ValueError, match="at most 256 points"):
        KB.mlp_bwd(embb, mw, draw)
    assert KB.mlp_bwd.launches == before


class _PlainCore(torch.autograd.Function):
    """MLPCore with both kernels replaced by their plain versions."""

    @staticmethod
    def forward(ctx, emb, *packed):
        embb = emb.to(torch.bfloat16)
        ctx.save_for_backward(embb, *packed)
        return K.mlp_fwd_plain(embb, K.cast_mlp_weights(packed))

    @staticmethod
    def backward(ctx, draw):
        embb, *packed = ctx.saved_tensors
        demb, grads = KB.mlp_bwd_plain(embb, K.cast_mlp_weights(packed), draw)
        return (demb, *grads)


@pytest.mark.cuda
def test_mlp_core_gradients_match_plain_function_on_cuda(model, cuda_device):
    """`MLPCore` through torch.autograd.grad, twice over one graph (as the
    training step does), against the same Function built from the plain
    versions: gradients reach the nn.Linear parameters through
    pack_mlp_weights."""
    gpu_model = NRNeRF(CFG, num_timesteps=1, device=cuda_device)
    gpu_model.load_state_dict(model.state_dict())
    net = gpu_model.coarse
    params = list(net.parameters())
    emb = torch.from_numpy(_emb(777, 9)).to(cuda_device).requires_grad_(True)
    cots = [torch.from_numpy(np.random.RandomState(s).randn(777, 8).astype(
        np.float32)).to(cuda_device) for s in (10, 11)]
    fwd0, bwd0 = K.mlp_fwd.launches, KB.mlp_bwd.launches
    out = KB.MLPCore.apply(emb, *K.pack_mlp_weights(net))
    ref = _PlainCore.apply(emb, *K.pack_mlp_weights(net))
    for k, cot in enumerate(cots):
        got = torch.autograd.grad(out, [emb] + params, cot, retain_graph=True)
        want = torch.autograd.grad(ref, [emb] + params, cot, retain_graph=True)
        assert KB.mlp_bwd.launches == bwd0 + k + 1
        for i, (a, b) in enumerate(zip(got, want)):
            l2 = (torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b)).item()
            assert l2 <= KB.BWD_TOL_L2, (k, i, l2)
            if i:       # parameters sum over the points; emb has gate flips
                scale = b.abs().max().item()
                assert (a - b).abs().max().item() <= KB.grad_max_tol(777) * scale
    assert K.mlp_fwd.launches == fwd0 + 1
    # the unused fifth output channel gets an exactly zero gradient
    assert got[-2][4:].abs().max().item() == 0.0


@pytest.mark.cuda
def test_renderer_on_cuda_runs_kernel_and_matches_cpu(model, cuda_device):
    """fused_kernel="auto" on the card launches the kernel once per pass and
    block and renders what the CPU renders with the kernel's plain version
    ("on" on a CPU tensor), up to the order of the f32 sums."""
    rs = RenderSettings(N_samples=16, N_importance=16, near=0.1,
                        far=1.6).test_mode()
    rng = np.random.RandomState(1)
    ro = np.tile([[0.0, 0.0, 0.6]], (64, 1)).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (64, 2)),
                         -np.ones((64, 1))], 1).astype(np.float32)
    lat = model.latents.detach().expand(64, -1)
    args = (torch.from_numpy(ro), torch.from_numpy(rd), lat)

    gpu_model = NRNeRF(CFG, num_timesteps=1, device=cuda_device)
    gpu_model.load_state_dict(model.state_dict())
    before = K.mlp_fwd.launches
    gpu = make_ray_renderer(CFG, rs, chunk=64, device=cuda_device)(
        gpu_model, *(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert K.mlp_fwd.launches == before + 2
    cpu = make_ray_renderer(ModelConfig(fused_kernel="on"), rs, chunk=64,
                            device="cpu")(model, *args)
    for key in ("rgb_map", "disp_map", "acc_map"):
        np.testing.assert_allclose(gpu[key].cpu().numpy(), cpu[key].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=key)


def _mlpv_weights(net, device):
    return tuple(w.detach().to(device) for w in
                 KV.cast_mlpv_weights(KV.pack_viewdirs_mlp_weights(net)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_mlpv_kernel_matches_plain_on_cuda(model_v, cuda_device, n):
    mw = _mlpv_weights(model_v.coarse, cuda_device)
    emb = torch.from_numpy(_emb(n, 3)).to(cuda_device)
    embv = torch.from_numpy(_embv(n, 4)).to(cuda_device)
    before = KV.mlpv_fwd.launches
    out = KV.mlpv_fwd(emb, embv, mw)
    torch.cuda.synchronize()
    assert KV.mlpv_fwd.launches == before + (n > 0)
    assert out.shape == (n, K.OUT_PAD) and out.dtype == torch.float32
    err = (out - KV.mlpv_fwd_plain(emb, embv, mw)).abs()
    if n:
        assert err.max().item() <= KV.BF16_TOL_MAX
        assert err.mean().item() <= KV.BF16_TOL_MEAN
    # deterministic: no atomics
    assert torch.equal(out, KV.mlpv_fwd(emb, embv, mw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_mlpv_bwd_kernel_matches_plain_on_cuda(model_v, cuda_device, n):
    mw = _mlpv_weights(model_v.fine, cuda_device)
    embb = torch.from_numpy(_emb(n, 5)).to(cuda_device).to(torch.bfloat16)
    embvb = torch.from_numpy(_embv(n, 6)).to(cuda_device).to(torch.bfloat16)
    draw = torch.from_numpy(np.random.RandomState(7).randn(n, 8).astype(
        np.float32)).to(cuda_device)
    before = KVB.mlpv_bwd.launches
    got = KVB.mlpv_bwd(embb, embvb, mw, draw)
    torch.cuda.synchronize()
    assert KVB.mlpv_bwd.launches == before + (n > 0)
    ref = KVB.mlpv_bwd_plain(embb, embvb, mw, draw)
    for a, b in zip([*got[:2], *got[2]], [*ref[:2], *ref[2]]):
        assert a.shape == b.shape and a.dtype == torch.float32
    if n:
        stats = KVB.bwd_agreement(got, ref)
        assert stats["ok"], stats
    # deterministic: fixed-order reduction, no atomics
    again = KVB.mlpv_bwd(embb, embvb, mw, draw)
    for a, b in zip([*got[:2], *got[2]], [*again[:2], *again[2]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mlpv_bwd_kernel_refuses_more_points_than_one_launch_takes(
        model_v, cuda_device, monkeypatch):
    """One call is one launch: more points than its scratch allows raise,
    and nothing is launched or counted. The limit keeps the scratch (9,984 B
    per point) at 2.44 GiB."""
    assert KVB.MAX_POINTS_PER_LAUNCH == 1 << 18
    assert KVB.SCRATCH_PER_POINT * 2 == 9984
    mw = _mlpv_weights(model_v.coarse, cuda_device)
    embb = torch.from_numpy(_emb(700, 7)).to(cuda_device).to(torch.bfloat16)
    embvb = torch.from_numpy(_embv(700, 8)).to(cuda_device).to(torch.bfloat16)
    draw = torch.from_numpy(np.random.RandomState(8).randn(700, 8).astype(
        np.float32)).to(cuda_device)
    monkeypatch.setattr(KVB, "MAX_POINTS_PER_LAUNCH", 256)
    before = KVB.mlpv_bwd.launches
    with pytest.raises(ValueError, match="at most 256 points"):
        KVB.mlpv_bwd(embb, embvb, mw, draw)
    assert KVB.mlpv_bwd.launches == before


class _PlainVCore(torch.autograd.Function):
    """MLPVCore with both kernels replaced by their plain versions."""

    @staticmethod
    def forward(ctx, emb, embv, *packed):
        embb, embvb = emb.to(torch.bfloat16), embv.to(torch.bfloat16)
        ctx.save_for_backward(embb, embvb, *packed)
        return KV.mlpv_fwd_plain(embb, embvb, KV.cast_mlpv_weights(packed))

    @staticmethod
    def backward(ctx, draw):
        embb, embvb, *packed = ctx.saved_tensors
        demb, dembv, grads = KVB.mlpv_bwd_plain(
            embb, embvb, KV.cast_mlpv_weights(packed), draw)
        return (demb, dembv, *grads)


@pytest.mark.cuda
def test_mlpv_core_gradients_match_plain_function_on_cuda(model_v, cuda_device):
    """`MLPVCore` through torch.autograd.grad, twice over one graph (as the
    training step does), against the same Function built from the plain
    versions: gradients reach both encodings and, through
    pack_viewdirs_mlp_weights, the nn.Linear parameters of the chain and of
    the four heads."""
    gpu_model = NRNeRF(CFG_V, num_timesteps=1, device=cuda_device)
    gpu_model.load_state_dict(model_v.state_dict())
    net = gpu_model.coarse
    params = list(net.parameters())
    emb = torch.from_numpy(_emb(777, 9)).to(cuda_device).requires_grad_(True)
    embv = torch.from_numpy(_embv(777, 10)).to(cuda_device).requires_grad_(True)
    cots = [torch.from_numpy(np.random.RandomState(s).randn(777, 8).astype(
        np.float32)).to(cuda_device) for s in (10, 11)]
    fwd0, bwd0 = KV.mlpv_fwd.launches, KVB.mlpv_bwd.launches
    out = KVB.MLPVCore.apply(emb, embv, *KV.pack_viewdirs_mlp_weights(net))
    ref = _PlainVCore.apply(emb, embv, *KV.pack_viewdirs_mlp_weights(net))
    for k, cot in enumerate(cots):
        got = torch.autograd.grad(out, [emb, embv] + params, cot,
                                  retain_graph=True)
        want = torch.autograd.grad(ref, [emb, embv] + params, cot,
                                   retain_graph=True)
        assert KVB.mlpv_bwd.launches == bwd0 + k + 1
        for i, (a, b) in enumerate(zip(got, want)):
            l2 = (torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b)).item()
            assert l2 <= KB.BWD_TOL_L2, (k, i, l2)
            if i > 1:   # parameters sum over the points; inputs have gate flips
                scale = b.abs().max().item()
                assert (a - b).abs().max().item() <= KB.grad_max_tol(777) * scale
    assert KV.mlpv_fwd.launches == fwd0 + 1
    assert len(got) == 2 + 16 + 8       # chain 8 x (w, b), heads 4 x (w, b)


# ---- fused_kernel="pts": the encoding computed in the kernel

def _bent_pts(n, seed=0):
    """Points in the range the bent sample points of a scene have: a few
    units around the origin, so the sines' arguments reach 2^9 * |x| in the
    thousands of radians."""
    return (np.random.RandomState(seed).randn(n, 3) * 1.5).astype(np.float32)


def _mlp_weights(net, device):
    return tuple(w.detach().to(device) for w in
                 K.cast_mlp_weights(K.pack_mlp_weights(net)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_mlpe_kernel_matches_plain_on_cuda(model, cuda_device, n):
    mw = _mlp_weights(model.coarse, cuda_device)
    pts = torch.from_numpy(_bent_pts(n, 3)).to(cuda_device)
    before = KE.mlpe_fwd.launches
    out = KE.mlpe_fwd(pts, mw)
    torch.cuda.synchronize()
    assert KE.mlpe_fwd.launches == before + (n > 0)
    assert out.shape == (n, K.OUT_PAD) and out.dtype == torch.float32
    err = (out - KE.mlpe_fwd_plain(pts, mw)).abs()
    if n:
        assert err.max().item() <= K.BF16_TOL_MAX
        assert err.mean().item() <= K.BF16_TOL_MEAN
    # deterministic: no atomics
    assert torch.equal(out, KE.mlpe_fwd(pts, mw))


@pytest.mark.cuda
def test_mlpe_kernel_takes_an_unaligned_view_of_the_points(model, cuda_device):
    """The coordinates are read one f32 at a time: a slice that starts 12
    bytes into an allocation is as good as the allocation."""
    mw = _mlp_weights(model.coarse, cuda_device)
    pts = torch.from_numpy(_bent_pts(301, 4)).to(cuda_device)
    assert torch.equal(KE.mlpe_fwd(pts[1:], mw), KE.mlpe_fwd(pts, mw)[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_mlpe_bwd_kernel_matches_plain_on_cuda(model, cuda_device, n):
    mw = _mlp_weights(model.fine, cuda_device)
    pts = torch.from_numpy(_bent_pts(n, 5)).to(cuda_device)
    draw = torch.from_numpy(np.random.RandomState(6).randn(n, 8).astype(
        np.float32)).to(cuda_device)
    before = KEB.mlpe_bwd.launches
    got = KEB.mlpe_bwd(pts, mw, draw)
    torch.cuda.synchronize()
    assert KEB.mlpe_bwd.launches == before + (n > 0)
    ref = KEB.mlpe_bwd_plain(pts, mw, draw)
    assert got[0].shape == (n, 3)
    for a, b in zip([got[0], *got[1]], [ref[0], *ref[1]]):
        assert a.shape == b.shape and a.dtype == torch.float32
    if n:
        stats = KEB.bwd_agreement(got, ref)
        assert stats["ok"], stats
    # deterministic: fixed-order sums, no atomics
    again = KEB.mlpe_bwd(pts, mw, draw)
    for a, b in zip([got[0], *got[1]], [again[0], *again[1]]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mlpe_bwd_kernel_refuses_more_points_than_one_launch_takes(
        model, cuda_device, monkeypatch):
    """One call is one launch: more points than its scratch allows raise,
    and nothing is launched or counted. The scratch holds the recomputed
    encoding where `mlp_bwd`'s holds its copy of the encoding, so it is the
    same 8,320 B per point and the same limit keeps it at 2 GiB."""
    assert KEB.MAX_POINTS_PER_LAUNCH == KB.MAX_POINTS_PER_LAUNCH == 1 << 18
    assert KEB.SCRATCH_PER_POINT * 2 == 8320
    mw = _mlp_weights(model.coarse, cuda_device)
    pts = torch.from_numpy(_bent_pts(700, 7)).to(cuda_device)
    draw = torch.from_numpy(np.random.RandomState(8).randn(700, 8).astype(
        np.float32)).to(cuda_device)
    monkeypatch.setattr(KEB, "MAX_POINTS_PER_LAUNCH", 256)
    before = KEB.mlpe_bwd.launches
    with pytest.raises(ValueError, match="at most 256 points"):
        KEB.mlpe_bwd(pts, mw, draw)
    assert KEB.mlpe_bwd.launches == before


class _PlainECore(torch.autograd.Function):
    """MLPECore with both kernels replaced by their plain versions."""

    @staticmethod
    def forward(ctx, pts, *packed):
        ctx.save_for_backward(pts, *packed)
        return KE.mlpe_fwd_plain(pts, K.cast_mlp_weights(packed))

    @staticmethod
    def backward(ctx, draw):
        pts, *packed = ctx.saved_tensors
        dpts, grads = KEB.mlpe_bwd_plain(pts, K.cast_mlp_weights(packed), draw)
        return (dpts, *grads)


@pytest.mark.cuda
def test_mlpe_core_gradients_match_plain_function_on_cuda(model, cuda_device):
    """`MLPECore` through torch.autograd.grad, twice over one graph (as the
    training step does), against the same Function built from the plain
    versions: gradients reach the points and, through pack_mlp_weights, the
    nn.Linear parameters. 65541 points: a flipped ReLU gate changes a point's
    whole row of dpts, amplified by the encoding's 2^k, and among a few
    hundred points one such row is over the L2 limit on its own."""
    gpu_model = NRNeRF(CFG, num_timesteps=1, device=cuda_device)
    gpu_model.load_state_dict(model.state_dict())
    net = gpu_model.coarse
    params = list(net.parameters())
    pts = torch.from_numpy(_bent_pts(65541, 9)).to(cuda_device).requires_grad_(True)
    cots = [torch.from_numpy(np.random.RandomState(s).randn(65541, 8).astype(
        np.float32)).to(cuda_device) for s in (10, 11)]
    fwd0, bwd0 = KE.mlpe_fwd.launches, KEB.mlpe_bwd.launches
    other0 = (K.mlp_fwd.launches, KB.mlp_bwd.launches)
    out = KEB.MLPECore.apply(pts, *K.pack_mlp_weights(net))
    ref = _PlainECore.apply(pts, *K.pack_mlp_weights(net))
    for k, cot in enumerate(cots):
        got = torch.autograd.grad(out, [pts] + params, cot, retain_graph=True)
        want = torch.autograd.grad(ref, [pts] + params, cot, retain_graph=True)
        assert KEB.mlpe_bwd.launches == bwd0 + k + 1
        assert got[0].shape == (65541, 3)
        for i, (a, b) in enumerate(zip(got, want)):
            l2 = (torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b)).item()
            assert l2 <= KB.BWD_TOL_L2, (k, i, l2)
            if i:       # parameters sum over the points; pts has gate flips
                scale = b.abs().max().item()
                assert (a - b).abs().max().item() <= KB.grad_max_tol(65541) * scale
    assert KE.mlpe_fwd.launches == fwd0 + 1
    assert (K.mlp_fwd.launches, KB.mlp_bwd.launches) == other0


@pytest.mark.cuda
def test_pts_renderer_on_cuda_runs_mlpe_and_matches_cpu(model, cuda_device):
    """fused_kernel="pts" on the card launches `mlpe_fwd` once per pass and
    block, `mlp_fwd` never, and renders what the CPU renders with the plain
    version, up to the order of the f32 sums."""
    cfg = ModelConfig(fused_kernel="pts")
    rs = RenderSettings(N_samples=16, N_importance=16, near=0.1,
                        far=1.6).test_mode()
    rng = np.random.RandomState(1)
    ro = np.tile([[0.0, 0.0, 0.6]], (64, 1)).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (64, 2)),
                         -np.ones((64, 1))], 1).astype(np.float32)
    lat = model.latents.detach().expand(64, -1)
    args = (torch.from_numpy(ro), torch.from_numpy(rd), lat)
    gpu_model = NRNeRF(CFG, num_timesteps=1, device=cuda_device)
    gpu_model.load_state_dict(model.state_dict())
    before, other = KE.mlpe_fwd.launches, K.mlp_fwd.launches
    gpu = make_ray_renderer(cfg, rs, chunk=64, device=cuda_device)(
        gpu_model, *(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert KE.mlpe_fwd.launches == before + 2
    assert K.mlp_fwd.launches == other
    cpu = make_ray_renderer(cfg, rs, chunk=64, device="cpu")(model, *args)
    for key in ("rgb_map", "disp_map", "acc_map"):
        np.testing.assert_allclose(gpu[key].cpu().numpy(), cpu[key].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=key)


# ---- fused_kernel="int8"

def _int8_weights(net, device, seed=0):
    """The 29 packed int8 weights of `net` on `device`, calibrated on
    encodings from a seed."""
    scales = KQ.calibrate_act_scales(net, torch.from_numpy(_emb(2048, seed)))
    return tuple(w.to(device) for w in KQ.pack_int8_mlp_weights(net, scales))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_int8_kernel_matches_plain_on_cuda(model, cuda_device, n):
    qw = _int8_weights(model.coarse, cuda_device)
    emb = torch.from_numpy(_emb(n, 3)).to(cuda_device).to(torch.bfloat16)
    before = KQ.mlp_i8.launches
    out = KQ.mlp_i8(emb, qw)
    torch.cuda.synchronize()
    assert KQ.mlp_i8.launches == before + (n > 0)
    assert out.shape == (n, K.OUT_PAD) and out.dtype == torch.float32
    ref = KQ.mlp_i8_plain(emb, qw)
    if n:
        # every layer up to h8 is bit-equal; the head's f32 sums differ in order
        assert (out - ref).abs().max().item() <= KQ.I8_TOL_MAX
        # and the quantized path stays near the bf16 one
        bf = K.mlp_fwd_plain(emb, _mlp_weights(model.coarse, cuda_device))
        assert ((out - bf).abs().mean() / bf.abs().mean()).item() < 0.02
    # deterministic: no atomics
    assert torch.equal(out, KQ.mlp_i8(emb, qw))


@pytest.mark.cuda
def test_int8_renderer_on_cuda_runs_mlp_i8_and_matches_cpu(model, cuda_device):
    """After `quantize_for_inference`, fused_kernel="int8" on the card
    launches `mlp_i8` once per pass and block, `mlp_fwd` never, and renders
    what the CPU renders with the plain version."""
    cfg = ModelConfig(fused_kernel="int8")
    rs = RenderSettings(N_samples=16, N_importance=16, near=0.1,
                        far=1.6).test_mode()
    rng = np.random.RandomState(1)
    ro = np.tile([[0.0, 0.0, 0.6]], (64, 1)).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (64, 2)),
                         -np.ones((64, 1))], 1).astype(np.float32)
    lat = model.latents.detach().expand(64, -1)
    args = (torch.from_numpy(ro), torch.from_numpy(rd), lat)
    gpu_model = NRNeRF(CFG, num_timesteps=1, device=cuda_device)
    gpu_model.load_state_dict(model.state_dict())
    gpu_args = tuple(a.to(cuda_device) for a in args)
    with pytest.raises(ValueError, match="quantize_for_inference"):
        make_ray_renderer(cfg, rs, chunk=64, device=cuda_device)(
            gpu_model, *gpu_args)
    gpu_q = KQ.quantize_for_inference(gpu_model, CFG, *gpu_args, 0.1, 1.6,
                                      n_rays=32, n_samples=16)
    assert gpu_model.quant is None
    assert gpu_q.quant["fine"].p0.device.type == "cuda"
    before, other = KQ.mlp_i8.launches, K.mlp_fwd.launches
    gpu = make_ray_renderer(cfg, rs, chunk=64, device=cuda_device)(
        gpu_q, *gpu_args)
    torch.cuda.synchronize()
    assert KQ.mlp_i8.launches == before + 2
    assert K.mlp_fwd.launches == other
    cpu_q = KQ.quantize_for_inference(model, CFG, *args, 0.1, 1.6, n_rays=32,
                                      n_samples=16)
    cpu = make_ray_renderer(cfg, rs, chunk=64, device="cpu")(cpu_q, *args)
    # the two calibrations may differ in a scale's last bit (f32 sums in
    # another order), which moves single activations by one int8 step
    for key in ("rgb_map", "acc_map"):
        assert np.abs(gpu[key].cpu().numpy() - cpu[key].numpy()).mean() < 5e-3


# ---- row 11 on the Hopper chain (csrc/mlp_i8.cu on mlp_sm90.cuh): the
# persistent grid's edges (one point, one tile, a tile and one, one tile past
# a whole wave of CTAs, a render block's fine pass: more tiles than CTAs),
# every size's rows bit for bit those of the largest launch, which alone is
# held to the plain version, bit-equal relaunch, the launch counter

SM90_I8_SIZES = [0, 1, 128, 129, 132 * 128 + 1, 1 << 22]


@pytest.fixture(scope="module")
def sm90_i8_reference(request):
    """The packed int8 weights, an encoding of the largest size and
    `mlp_i8`'s output on it, held once against `mlp_i8_plain`."""
    cache = {}

    def get(device):
        if not cache:
            qw = _int8_weights(request.getfixturevalue("model").coarse, device)
            emb = torch.from_numpy(_emb(max(SM90_I8_SIZES), 51)).to(
                device).to(torch.bfloat16)
            out = KQ.mlp_i8(emb, qw)
            err = (out - KQ.mlp_i8_plain(emb, qw)).abs().max().item()
            assert err <= KQ.I8_TOL_MAX
            cache.update(qw=qw, emb=emb, out=out)
        return cache

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_I8_SIZES)
def test_mlp_i8_on_the_sm90_chain_at_the_grid_edges(sm90_i8_reference,
                                                     cuda_device, n):
    ref = sm90_i8_reference(cuda_device)
    emb = ref["emb"][:n]
    before = KQ.mlp_i8.launches
    out = KQ.mlp_i8(emb, ref["qw"])
    torch.cuda.synchronize()
    assert KQ.mlp_i8.launches == before + (n > 0)
    assert out.shape == (n, K.OUT_PAD) and bool(torch.isfinite(out).all())
    assert torch.equal(out, ref["out"][:n])
    assert torch.equal(out, KQ.mlp_i8(emb, ref["qw"]))


@pytest.mark.cuda
def test_mlp_i8_refuses_an_unaligned_cuda_tensor(model, cuda_device):
    """A bf16 encoding that starts 2 bytes into its allocation raises and
    launches nothing; an aligned copy of it runs."""
    qw = _int8_weights(model.coarse, cuda_device)
    flat = torch.from_numpy(_emb(9, 52)).to(cuda_device).to(
        torch.bfloat16).reshape(-1)
    emb = flat[1:1 + 8 * 64].view(8, 64)
    assert emb.data_ptr() % 16 == 2 and emb.is_contiguous()
    before = KQ.mlp_i8.launches
    with pytest.raises(ValueError, match="16-byte aligned"):
        KQ.mlp_i8(emb, qw)
    assert KQ.mlp_i8.launches == before
    out = KQ.mlp_i8(emb.clone(), qw)
    assert (out - KQ.mlp_i8_plain(emb, qw)).abs().max().item() <= KQ.I8_TOL_MAX


# ---- the fused point query: bend_fwd, bend_bwd, fused_fwd, fused_bwd

def _bend_inputs(n, device, seed):
    """Points where the synthetic scene's bent points lie (the sines'
    arguments reach hundreds of radians), latents of the model's scale."""
    rng = np.random.RandomState(seed)
    lo, hi = np.array([-0.8, -0.8, -1.0]), np.array([0.8, 0.8, 0.5])
    pts = (lo + (hi - lo) * rng.uniform(size=(n, 3))).astype(np.float32)
    lat = (0.1 * rng.randn(n, 32)).astype(np.float32)
    return (torch.from_numpy(pts).to(device), torch.from_numpy(lat).to(device),
            rng)


def _fused_weights(model, device, network="coarse"):
    return tuple(w.detach().to(device) for w in FF.cast_fused_weights(
        FQ.pack_fused_weights(model, network=network)))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 128, 129, 4096 + 5, 132 * 128 + 1])
def test_bend_kernels_match_plain_on_cuda(model, cuda_device, n):
    w = _fused_weights(model, cuda_device)[:18]
    pts, lat, rng = _bend_inputs(n, cuda_device, 11)
    before = (BF.bend_fwd.launches, BB.bend_bwd.launches)
    emb, off, rig = BF.bend_fwd(pts, lat, w)
    cots = [torch.from_numpy((s * rng.randn(n, c)).astype(np.float32)).to(
        cuda_device) for c, s in ((64, 0.1), (3, 1.0), (1, 1.0))]
    got = BB.bend_bwd(pts, lat, w, *cots)
    torch.cuda.synchronize()
    assert (BF.bend_fwd.launches, BB.bend_bwd.launches) == (
        before[0] + (n > 0), before[1] + (n > 0))
    assert emb.shape == (n, 64) and off.shape == (n, 3) and rig.shape == (n, 1)
    if n:
        stats = BF.bend_fwd_agreement((emb, off, rig),
                                      BF.bend_fwd_plain(pts, lat, w))
        assert stats["ok"], stats
        stats = BB.bend_bwd_agreement(got, BB.bend_bwd_plain(pts, lat, w, *cots))
        assert stats["ok"], stats
    # deterministic: no atomics
    assert all(torch.equal(a, b) for a, b in zip((emb, off, rig),
                                                  BF.bend_fwd(pts, lat, w)))
    again = BB.bend_bwd(pts, lat, w, *cots)
    assert all(torch.equal(a, b) for a, b in zip(
        [got[0], got[1], *got[2]], [again[0], again[1], *again[2]]))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 65536 + 5])
def test_fused_kernels_match_plain_on_cuda(model, cuda_device, n):
    """At the last size a few ReLU gates of the chain flip with the
    encoding's flipped points, as at a training step's 65,536 points; among a
    few thousand points one flip is over the L2 limit on its own (0.013 at
    4,101 points on an H100)."""
    w = _fused_weights(model, cuda_device, "fine")
    pts, lat, rng = _bend_inputs(n, cuda_device, 12)
    before = (FF.fused_fwd.launches, FB.fused_bwd.launches)
    raw, off, rig = FF.fused_fwd(pts, lat, w)
    cots = [torch.from_numpy(rng.randn(n, c).astype(np.float32)).to(cuda_device)
            for c in (8, 3, 1)]
    got = FB.fused_bwd(pts, lat, w, *cots)
    torch.cuda.synchronize()
    assert (FF.fused_fwd.launches, FB.fused_bwd.launches) == (
        before[0] + (n > 0), before[1] + (n > 0))
    assert raw.shape == (n, 8) and len(got[2]) == 35
    if n:
        stats = FF.fused_fwd_agreement((raw, off, rig),
                                       FF.fused_fwd_plain(pts, lat, w))
        assert stats["ok"], stats
        stats = FB.fused_bwd_agreement(got, FB.fused_bwd_plain(pts, lat, w, *cots))
        assert stats["ok"], stats
    assert all(torch.equal(a, b) for a, b in zip((raw, off, rig),
                                                  FF.fused_fwd(pts, lat, w)))
    again = FB.fused_bwd(pts, lat, w, *cots)
    assert all(torch.equal(a, b) for a, b in zip(
        [got[0], got[1], *got[2]], [again[0], again[1], *again[2]]))


@pytest.mark.cuda
def test_bender_kernels_take_unaligned_views_of_the_inputs(model, cuda_device):
    """The kernels read the latents 4 floats at a time: a view that starts
    off a 16-byte boundary is copied by the wrappers, and the results are the
    aligned inputs' bit for bit."""
    w = _fused_weights(model, cuda_device)
    pts, lat, _ = _bend_inputs(300, cuda_device, 14)
    flat = torch.zeros(300 * 32 + 1, device=cuda_device)
    flat[1:] = lat.flatten()
    lat_view = flat[1:].view(300, 32)
    pts_view = torch.zeros(300 * 3 + 1, device=cuda_device)
    pts_view[1:] = pts.flatten()
    pts_view = pts_view[1:].view(300, 3)
    assert lat_view.data_ptr() % 16 and lat_view.is_contiguous()
    for fn, ws in ((BF.bend_fwd, w[:18]), (FF.fused_fwd, w)):
        for a, b in zip(fn(pts_view, lat_view, ws), fn(pts, lat, ws)):
            assert torch.equal(a, b)
    cots = [torch.ones(300, c, device=cuda_device) for c in (8, 3, 1)]
    a = FB.fused_bwd(pts_view, lat_view, w, *cots)
    b = FB.fused_bwd(pts, lat, w, *cots)
    assert all(torch.equal(x, y) for x, y in zip([a[0], a[1], *a[2]],
                                                  [b[0], b[1], *b[2]]))


@pytest.mark.cuda
def test_bender_backwards_refuse_more_points_than_one_launch_takes(
        model, cuda_device):
    w = _fused_weights(model, cuda_device)
    n = KB.MAX_POINTS_PER_LAUNCH + 1
    pts, lat = torch.zeros(n, 3, device=cuda_device), torch.zeros(
        n, 32, device=cuda_device)
    z3, z1 = torch.zeros(n, 3, device=cuda_device), torch.zeros(
        n, 1, device=cuda_device)
    with pytest.raises(ValueError, match="at most"):
        BB.bend_bwd(pts, lat, w[:18], torch.zeros(n, 64, device=cuda_device),
                    z3, z1)
    with pytest.raises(ValueError, match="at most"):
        FB.fused_bwd(pts, lat, w, torch.zeros(n, 8, device=cuda_device), z3, z1)


def _entry_grads(entry, model, pts, lat):
    pts = pts.clone().requires_grad_(True)
    lat = lat.clone().requires_grad_(True)
    out = entry(model, pts, lat)
    loss = (out[0] ** 2).mean() + 10 * (out[1] ** 2).mean() + (out[2] ** 2).mean()
    params = [p for n, p in model.named_parameters()
              if n.startswith(("coarse.", "bender."))]
    return out, torch.autograd.grad(loss, [pts, lat] + params)


@pytest.mark.cuda
def test_entry_points_on_cuda_split_equals_monolith(model, cuda_device):
    """Both entry points on the card: the launch counts (one fused_fwd and
    one fused_bwd; one bend_fwd, mlp_fwd, mlp_bwd and bend_bwd), the split
    bit-equal to the monolith in value and gradient, and the gradients close
    to the CPU's (the plain versions) at 6% of each one's max magnitude."""
    m = model.to(cuda_device)
    try:
        pts, lat, _ = _bend_inputs(65536 + 3, cuda_device, 13)
        wrappers = (FF.fused_fwd, FB.fused_bwd, BF.bend_fwd, BB.bend_bwd,
                    K.mlp_fwd, KB.mlp_bwd, KE.mlpe_fwd, KEB.mlpe_bwd)
        for w_ in wrappers:
            w_.launches = 0
        mono = _entry_grads(FQ.fused_point_query, m, pts, lat)
        counts = [w_.launches for w_ in wrappers]
        split = _entry_grads(FQ.fused_point_query_split, m, pts, lat)
        torch.cuda.synchronize()
        assert counts == [1, 1, 0, 0, 0, 0, 0, 0]
        assert [w_.launches for w_ in wrappers] == [1, 1, 1, 1, 1, 1, 0, 0]
        for a, b in zip(mono[0] + mono[1], split[0] + split[1]):
            assert torch.equal(a, b)
    finally:
        model.to("cpu")
    cpu = _entry_grads(FQ.fused_point_query, model, pts.cpu()[:4099],
                       lat.cpu()[:4099])
    card = _entry_grads(FQ.fused_point_query, m.to(cuda_device),
                        pts[:4099], lat[:4099])
    model.to("cpu")
    for a, b in zip(card[1], cpu[1]):
        scale = max(float(b.abs().max()), 1e-6)
        assert float((a.cpu() - b).abs().max()) / scale < 0.06


# ---- the time-conditioned baseline: mlp_fwd and mlp_bwd at 128 lanes

CFG_TC = ModelConfig(ray_bending=None, time_conditioned_baseline=True)


@pytest.fixture(scope="module")
def model_tc():
    """The baseline from a seed: no bender, a nonzero latent table, so the
    latent lanes 63 .. 94 of the MLP input carry signal."""
    gen = torch.Generator().manual_seed(2)
    m = NRNeRF(CFG_TC, num_timesteps=2, generator=gen, device="cpu")
    with torch.no_grad():
        m.latents.copy_(0.3 * torch.randn(m.latents.shape, generator=gen))
        for net in (m.coarse, m.fine):
            net.output.bias[3] += 1.0
    return m


def _emb_tc(n, seed=0):
    """63 encoding lanes and 32 latent lanes, the rest zero."""
    rng = np.random.RandomState(seed)
    emb = np.zeros((n, 128), np.float32)
    emb[:, :63] = rng.uniform(-1, 1, (n, 63))
    emb[:, 63:95] = 0.3 * rng.randn(n, 32)
    return emb


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_kernel_matches_plain_on_cuda_at_128_lanes(model_tc, cuda_device, n):
    mw = tuple(w.detach().to(cuda_device) for w in
               K.cast_mlp_weights(K.pack_mlp_weights(model_tc.coarse)))
    assert mw[0].shape == mw[10].shape == (128, 256)
    emb = torch.from_numpy(_emb_tc(n, 3)).to(cuda_device)
    before = dict(K.mlp_fwd.launches_by_width)
    out = K.mlp_fwd(emb, mw)
    torch.cuda.synchronize()
    assert K.mlp_fwd.launches_by_width == {64: before[64],
                                           128: before[128] + (n > 0)}
    assert out.shape == (n, K.OUT_PAD) and out.dtype == torch.float32
    err = (out - K.mlp_fwd_plain(emb, mw)).abs()
    if n:
        assert err.max().item() <= K.BF16_TOL_MAX
        assert err.mean().item() <= K.BF16_TOL_MEAN
    assert torch.equal(out, K.mlp_fwd(emb, mw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", [0, 1, 127, 129, 4096 + 5])
def test_bwd_kernel_matches_plain_on_cuda_at_128_lanes(model_tc, cuda_device, n):
    mw = tuple(w.detach().to(cuda_device) for w in
               K.cast_mlp_weights(K.pack_mlp_weights(model_tc.fine)))
    embb = torch.from_numpy(_emb_tc(n, 5)).to(cuda_device).to(torch.bfloat16)
    draw = torch.from_numpy(np.random.RandomState(6).randn(n, 8).astype(
        np.float32)).to(cuda_device)
    before = dict(KB.mlp_bwd.launches_by_width)
    got = KB.mlp_bwd(embb, mw, draw)
    torch.cuda.synchronize()
    assert KB.mlp_bwd.launches_by_width == {64: before[64],
                                            128: before[128] + (n > 0)}
    assert got[0].shape == (n, 128) and got[1][0].shape == (128, 256)
    _assert_bwd_close(got, KB.mlp_bwd_plain(embb, mw, draw))
    if n:       # the latents' lanes get a gradient, the pad lanes none
        assert got[0][:, 63:95].abs().max().item() > 0
        assert got[0][:, 95:].abs().max().item() == 0
    again = KB.mlp_bwd(embb, mw, draw)
    assert torch.equal(got[0], again[0])
    for a, b in zip(got[1], again[1]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_mlp_core_gradients_match_plain_function_on_cuda_at_128_lanes(
        model_tc, cuda_device):
    """`MLPCore` on the baseline's 95-channel input padded to 128 lanes,
    twice over one graph, against the plain versions: the latents' gradient
    comes back through the padding."""
    gpu_model = NRNeRF(CFG_TC, num_timesteps=2, device=cuda_device)
    gpu_model.load_state_dict(model_tc.state_dict())
    net = gpu_model.coarse
    params = list(net.parameters())
    x = torch.from_numpy(_emb_tc(777, 9)[:, :95]).to(cuda_device)
    x.requires_grad_(True)
    emb = torch.nn.functional.pad(x, (0, 33))
    cots = [torch.from_numpy(np.random.RandomState(s).randn(777, 8).astype(
        np.float32)).to(cuda_device) for s in (10, 11)]
    out = KB.MLPCore.apply(emb, *K.pack_mlp_weights(net))
    ref = _PlainCore.apply(emb, *K.pack_mlp_weights(net))
    for cot in cots:
        got = torch.autograd.grad(out, [x] + params, cot, retain_graph=True)
        want = torch.autograd.grad(ref, [x] + params, cot, retain_graph=True)
        assert got[0][:, 63:].abs().max().item() > 0
        for i, (a, b) in enumerate(zip(got, want)):
            l2 = (torch.linalg.vector_norm(a - b)
                  / torch.linalg.vector_norm(b)).item()
            assert l2 <= KB.BWD_TOL_L2, (i, l2)


@pytest.mark.cuda
def test_baseline_renderer_on_cuda_runs_kernel_and_matches_cpu(model_tc,
                                                               cuda_device):
    """The baseline with fused_kernel="auto" on the card: mlp_fwd at 128
    lanes once per pass and block, and what the CPU renders with the plain
    version."""
    rs = RenderSettings(N_samples=16, N_importance=16, near=0.1,
                        far=1.6).test_mode()
    rng = np.random.RandomState(1)
    ro = np.tile([[0.0, 0.0, 0.6]], (64, 1)).astype(np.float32)
    rd = np.concatenate([rng.uniform(-0.4, 0.4, (64, 2)),
                         -np.ones((64, 1))], 1).astype(np.float32)
    lat = model_tc.latents.detach()[torch.arange(64) % 2]
    args = (torch.from_numpy(ro), torch.from_numpy(rd), lat)

    gpu_model = NRNeRF(CFG_TC, num_timesteps=2, device=cuda_device)
    gpu_model.load_state_dict(model_tc.state_dict())
    before = K.mlp_fwd.launches_by_width[128]
    gpu = make_ray_renderer(CFG_TC, rs, chunk=64, device=cuda_device)(
        gpu_model, *(a.to(cuda_device) for a in args))
    torch.cuda.synchronize()
    assert K.mlp_fwd.launches_by_width[128] == before + 2
    cpu = make_ray_renderer(ModelConfig(ray_bending=None,
                                        time_conditioned_baseline=True,
                                        fused_kernel="on"), rs, chunk=64,
                            device="cpu")(model_tc, *args)
    for key in ("rgb_map", "disp_map", "acc_map"):
        np.testing.assert_allclose(gpu[key].cpu().numpy(), cpu[key].numpy(),
                                   rtol=1e-3, atol=1e-3, err_msg=key)


# ---- rows 1-2 on the Hopper chain (csrc/mlp_sm90.cuh) at both widths: the
# persistent grid's edges (fewer tiles than SMs, one tile past a whole wave,
# the backward's largest call, the forward's fine pass), bit-equal relaunch,
# the launch counters

SM90_FWD_SIZES = [0, 1, 127, 129, 132 * 128 + 1, 1 << 22]
SM90_BWD_SIZES = [0, 1, 127, 129, 132 * 128 + 1, 1 << 18]


def _width_weights(request, width, device, network):
    return _model_weights(request.getfixturevalue(
        "model" if width == 64 else "model_tc"), device, network)


def _model_weights(m, device, network):
    return tuple(w.detach().to(device) for w in
                 K.cast_mlp_weights(K.pack_mlp_weights(m.network(network))))


def _width_emb(width, n, seed):
    return _emb(n, seed) if width == 64 else _emb_tc(n, seed)


@pytest.fixture(scope="module")
def sm90_fwd_reference(request):
    """Per width: the weights, an encoding of the largest size and the
    kernel's output on it, held once against the plain version (the bf16
    tolerances are statistics over many points)."""
    cache = {}
    models = {64: request.getfixturevalue("model"),
              128: request.getfixturevalue("model_tc")}

    def get(width, device):
        if width not in cache:
            mw = _model_weights(models[width], device, "coarse")
            emb = torch.from_numpy(_width_emb(width, max(SM90_FWD_SIZES),
                                              21)).to(device)
            out = K.mlp_fwd(emb, mw)
            err = (out - K.mlp_fwd_plain(emb, mw)).abs()
            assert err.max().item() <= K.BF16_TOL_MAX
            assert err.mean().item() <= K.BF16_TOL_MEAN
            cache[width] = (mw, emb, out)
        return cache[width]

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_FWD_SIZES)
@pytest.mark.parametrize("width", [64, 128])
def test_mlp_fwd_on_the_sm90_chain_at_the_grid_edges(sm90_fwd_reference,
                                                      cuda_device, width, n):
    """Every size gives bit for bit the rows that the largest launch gives
    (a point's arithmetic does not depend on its tile, its CTA or the
    grid), the largest launch agrees with the plain version, and a relaunch
    is bit-equal."""
    mw, emb_all, ref = sm90_fwd_reference(width, cuda_device)
    emb = emb_all[:n]
    before = dict(K.mlp_fwd.launches_by_width)
    out = K.mlp_fwd(emb, mw)
    torch.cuda.synchronize()
    after = dict(before)
    after[width] += n > 0
    assert K.mlp_fwd.launches_by_width == after
    assert out.shape == (n, K.OUT_PAD) and bool(torch.isfinite(out).all())
    assert torch.equal(out, ref[:n])
    assert torch.equal(out, K.mlp_fwd(emb, mw))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_BWD_SIZES)
@pytest.mark.parametrize("width", [64, 128])
def test_mlp_bwd_on_the_sm90_chain_at_the_grid_edges(request, cuda_device, width, n):
    mw = _width_weights(request, width, cuda_device, "fine")
    embb = torch.from_numpy(_width_emb(width, n, 5)).to(cuda_device).to(
        torch.bfloat16)
    draw = torch.from_numpy(np.random.RandomState(6).randn(n, 8).astype(
        np.float32)).to(cuda_device)
    before = dict(KB.mlp_bwd.launches_by_width)
    got = KB.mlp_bwd(embb, mw, draw)
    torch.cuda.synchronize()
    after = dict(before)
    after[width] += n > 0
    assert KB.mlp_bwd.launches_by_width == after
    assert got[0].shape == (n, width)
    if n:
        _assert_bwd_close(got, KB.mlp_bwd_plain(embb, mw, draw))
    again = KB.mlp_bwd(embb, mw, draw)
    assert torch.equal(got[0], again[0])
    for a, b in zip(got[1], again[1]):
        assert torch.equal(a, b)


# ---- rows 4 and 6 on the Hopper chain (csrc/mlp_sm90.cuh): the persistent
# grid's edges, every size's per-point outputs bit for bit the rows of the
# largest launch, which alone is held to the plain version (the tolerances
# are statistics over many points), bit-equal relaunch, the launch counters


@pytest.fixture(scope="module")
def sm90_views_bwd_reference(request):
    """The weights, inputs of the largest size and the kernel's outputs on
    them, held once against `mlpv_bwd_plain`."""
    cache = {}

    def get(device):
        if not cache:
            mw = _mlpv_weights(request.getfixturevalue("model_v").fine, device)
            n = max(SM90_BWD_SIZES)
            embb = torch.from_numpy(_emb(n, 31)).to(device).to(torch.bfloat16)
            embvb = torch.from_numpy(_embv(n, 32)).to(device).to(torch.bfloat16)
            draw = torch.from_numpy(np.random.RandomState(33).randn(n, 8).astype(
                np.float32)).to(device)
            got = KVB.mlpv_bwd(embb, embvb, mw, draw)
            stats = KVB.bwd_agreement(got, KVB.mlpv_bwd_plain(embb, embvb, mw, draw))
            assert stats["ok"], stats
            cache.update(mw=mw, inputs=(embb, embvb, draw), out=got)
        return cache

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_BWD_SIZES)
def test_mlpv_bwd_on_the_sm90_chain_at_the_grid_edges(sm90_views_bwd_reference,
                                                      cuda_device, n):
    ref = sm90_views_bwd_reference(cuda_device)
    embb, embvb, draw = (x[:n] for x in ref["inputs"])
    before = KVB.mlpv_bwd.launches
    got = KVB.mlpv_bwd(embb, embvb, ref["mw"], draw)
    torch.cuda.synchronize()
    assert KVB.mlpv_bwd.launches == before + (n > 0)
    assert got[0].shape == (n, 64) and got[1].shape == (n, 32)
    assert len(got[2]) == len(ref["out"][2])
    assert all(bool(torch.isfinite(g).all()) for g in got[2])
    assert torch.equal(got[0], ref["out"][0][:n])
    assert torch.equal(got[1], ref["out"][1][:n])
    again = KVB.mlpv_bwd(embb, embvb, ref["mw"], draw)
    for a, b in zip([*got[:2], *got[2]], [*again[:2], *again[2]]):
        assert torch.equal(a, b)


@pytest.fixture(scope="module")
def sm90_pts_bwd_reference(request):
    """As `sm90_views_bwd_reference`, for `mlpe_bwd`."""
    cache = {}

    def get(device):
        if not cache:
            mw = _mlp_weights(request.getfixturevalue("model").fine, device)
            n = max(SM90_BWD_SIZES)
            pts = torch.from_numpy(_bent_pts(n, 34)).to(device)
            draw = torch.from_numpy(np.random.RandomState(35).randn(n, 8).astype(
                np.float32)).to(device)
            got = KEB.mlpe_bwd(pts, mw, draw)
            stats = KEB.bwd_agreement(got, KEB.mlpe_bwd_plain(pts, mw, draw))
            assert stats["ok"], stats
            cache.update(mw=mw, inputs=(pts, draw), out=got)
        return cache

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_BWD_SIZES)
def test_mlpe_bwd_on_the_sm90_chain_at_the_grid_edges(sm90_pts_bwd_reference,
                                                      cuda_device, n):
    ref = sm90_pts_bwd_reference(cuda_device)
    pts, draw = (x[:n] for x in ref["inputs"])
    before = KEB.mlpe_bwd.launches
    got = KEB.mlpe_bwd(pts, ref["mw"], draw)
    torch.cuda.synchronize()
    assert KEB.mlpe_bwd.launches == before + (n > 0)
    assert got[0].shape == (n, 3) and len(got[1]) == len(ref["out"][1])
    assert all(bool(torch.isfinite(g).all()) for g in got[1])
    assert torch.equal(got[0], ref["out"][0][:n])
    again = KEB.mlpe_bwd(pts, ref["mw"], draw)
    for a, b in zip([got[0], *got[1]], [again[0], *again[1]]):
        assert torch.equal(a, b)


# ---- rows 3 and 5 on the Hopper chain (csrc/mlp_sm90.cuh): the persistent
# grid's edges (one point, a tile less one, one tile, a tile and one, one
# tile past a whole wave of CTAs, a render block's fine pass: more tiles
# than CTAs), every size's rows bit for bit those of the largest launch,
# which alone is held to the plain version within the limits of
# `test_mlpv_kernel_matches_plain_on_cuda` and
# `test_mlpe_kernel_matches_plain_on_cuda`, bit-equal relaunch, the launch
# counters

SM90_HEADS_FWD_SIZES = [0, 1, 127, 128, 129, 132 * 128 + 1, 1 << 22]


@pytest.fixture(scope="module")
def sm90_views_fwd_reference(request):
    """The weights, inputs of the largest size and `mlpv_fwd`'s output on
    them, held once against `mlpv_fwd_plain`."""
    cache = {}

    def get(device):
        if not cache:
            mw = _mlpv_weights(request.getfixturevalue("model_v").coarse, device)
            n = max(SM90_HEADS_FWD_SIZES)
            emb = torch.from_numpy(_emb(n, 41)).to(device)
            embv = torch.from_numpy(_embv(n, 42)).to(device)
            out = KV.mlpv_fwd(emb, embv, mw)
            err = (out - KV.mlpv_fwd_plain(emb, embv, mw)).abs()
            assert err.max().item() <= KV.BF16_TOL_MAX
            assert err.mean().item() <= KV.BF16_TOL_MEAN
            cache.update(mw=mw, inputs=(emb, embv), out=out)
        return cache

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_HEADS_FWD_SIZES)
def test_mlpv_fwd_on_the_sm90_chain_at_the_grid_edges(sm90_views_fwd_reference,
                                                      cuda_device, n):
    ref = sm90_views_fwd_reference(cuda_device)
    emb, embv = (x[:n] for x in ref["inputs"])
    before = KV.mlpv_fwd.launches
    out = KV.mlpv_fwd(emb, embv, ref["mw"])
    torch.cuda.synchronize()
    assert KV.mlpv_fwd.launches == before + (n > 0)
    assert out.shape == (n, K.OUT_PAD) and bool(torch.isfinite(out).all())
    assert torch.equal(out, ref["out"][:n])
    assert torch.equal(out, KV.mlpv_fwd(emb, embv, ref["mw"]))


@pytest.fixture(scope="module")
def sm90_pts_fwd_reference(request):
    """As `sm90_views_fwd_reference`, for `mlpe_fwd`; the points are a view
    that starts 4 bytes into its allocation, so no row is 16-byte aligned
    the way a fresh tensor's is."""
    cache = {}

    def get(device):
        if not cache:
            mw = _mlp_weights(request.getfixturevalue("model").coarse, device)
            n = max(SM90_HEADS_FWD_SIZES)
            flat = torch.from_numpy(_bent_pts(n + 1, 43)).to(device).reshape(-1)
            pts = flat[1:1 + 3 * n].view(n, 3)
            assert pts.data_ptr() % 16 == 4 and pts.is_contiguous()
            out = KE.mlpe_fwd(pts, mw)
            err = (out - KE.mlpe_fwd_plain(pts, mw)).abs()
            assert err.max().item() <= K.BF16_TOL_MAX
            assert err.mean().item() <= K.BF16_TOL_MEAN
            cache.update(mw=mw, pts=pts, out=out)
        return cache

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_HEADS_FWD_SIZES)
def test_mlpe_fwd_on_the_sm90_chain_at_the_grid_edges(sm90_pts_fwd_reference,
                                                      cuda_device, n):
    """... and on an unaligned view of the points as on an aligned copy."""
    ref = sm90_pts_fwd_reference(cuda_device)
    pts = ref["pts"][:n]
    before = KE.mlpe_fwd.launches
    out = KE.mlpe_fwd(pts, ref["mw"])
    torch.cuda.synchronize()
    assert KE.mlpe_fwd.launches == before + (n > 0)
    assert out.shape == (n, K.OUT_PAD) and bool(torch.isfinite(out).all())
    assert torch.equal(out, ref["out"][:n])
    assert torch.equal(out, KE.mlpe_fwd(pts, ref["mw"]))
    assert torch.equal(out, KE.mlpe_fwd(pts.clone(), ref["mw"]))


@pytest.mark.cuda
def test_mlpe_fwd_matches_mlp_fwd_on_its_encoding(model, cuda_device):
    """Row 5 runs row 1's kernel on another input: on the points it agrees
    with row 1 on the encoding that `embed_ew` computes in PyTorch and
    rounds to bf16 (the same arithmetic but for the sines of another
    library, which flip an occasional bf16 rounding), within `mlp_fwd`'s
    tolerances."""
    mw = _mlp_weights(model.coarse, cuda_device)
    pts = torch.from_numpy(_bent_pts(4096 + 5, 44)).to(cuda_device)
    emb = KE.embed_ew(pts)[1].to(torch.bfloat16)
    got = KE.mlpe_fwd(pts, mw)
    via_emb = K.mlp_fwd(emb, mw)
    err = (got - via_emb).abs()
    assert err.max().item() <= K.BF16_TOL_MAX
    assert err.mean().item() <= K.BF16_TOL_MEAN


# ---- rows 9 and 10 on the Hopper chain (csrc/fused_fwd.cu and fused_bwd.cu
# on mlp_sm90.cuh): the persistent grid's edges (one point, a tile less one,
# one tile, a tile and one, one tile past a whole wave of CTAs, the largest
# launch: 2^22 forward, 2^18 backward), every size's per-point outputs bit
# for bit the rows of the largest launch, which alone is held to the plain
# version (the tolerances are statistics over many points), bit-equal
# relaunch, the launch counters; the split equal to the monolith at more
# tiles than CTAs

SM90_FUSED_FWD_SIZES = [0, 1, 127, 128, 129, 132 * 128 + 1, 1 << 22]
SM90_FUSED_BWD_SIZES = [0, 1, 127, 128, 129, 132 * 128 + 1, 1 << 18]


@pytest.fixture(scope="module")
def sm90_fused_reference(request):
    """The fine network's packed weights, inputs of each direction's largest
    size and the kernels' outputs on them, held once against the plain
    versions."""
    cache = {}

    def get(device):
        if not cache:
            w = _fused_weights(request.getfixturevalue("model"), device, "fine")
            pts, lat, rng = _bend_inputs(max(SM90_FUSED_FWD_SIZES), device, 61)
            out = FF.fused_fwd(pts, lat, w)
            stats = FF.fused_fwd_agreement(out, FF.fused_fwd_plain(pts, lat, w))
            assert stats["ok"], stats
            nb = max(SM90_FUSED_BWD_SIZES)
            cots = [torch.from_numpy(rng.randn(nb, c).astype(np.float32)).to(device)
                    for c in (8, 3, 1)]
            got = FB.fused_bwd(pts[:nb], lat[:nb], w, *cots)
            stats = FB.fused_bwd_agreement(
                got, FB.fused_bwd_plain(pts[:nb], lat[:nb], w, *cots))
            assert stats["ok"], stats
            cache.update(w=w, pts=pts, lat=lat, out=out, cots=cots, grads=got)
        return cache

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_FUSED_FWD_SIZES)
def test_fused_fwd_on_the_sm90_chain_at_the_grid_edges(sm90_fused_reference,
                                                       cuda_device, n):
    ref = sm90_fused_reference(cuda_device)
    pts, lat = ref["pts"][:n], ref["lat"][:n]
    before = FF.fused_fwd.launches
    out = FF.fused_fwd(pts, lat, ref["w"])
    torch.cuda.synchronize()
    assert FF.fused_fwd.launches == before + (n > 0)
    assert [tuple(t.shape) for t in out] == [(n, 8), (n, 3), (n, 1)]
    assert all(bool(torch.isfinite(t).all()) for t in out)
    for a, b in zip(out, ref["out"]):
        assert torch.equal(a, b[:n])
    assert all(torch.equal(a, b) for a, b in zip(out, FF.fused_fwd(pts, lat, ref["w"])))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_FUSED_BWD_SIZES)
def test_fused_bwd_on_the_sm90_chain_at_the_grid_edges(sm90_fused_reference,
                                                       cuda_device, n):
    ref = sm90_fused_reference(cuda_device)
    pts, lat = ref["pts"][:n], ref["lat"][:n]
    cots = [c[:n] for c in ref["cots"]]
    before = FB.fused_bwd.launches
    got = FB.fused_bwd(pts, lat, ref["w"], *cots)
    torch.cuda.synchronize()
    assert FB.fused_bwd.launches == before + (n > 0)
    assert got[0].shape == (n, 3) and got[1].shape == (n, 32) and len(got[2]) == 35
    assert all(bool(torch.isfinite(g).all()) for g in got[2])
    assert torch.equal(got[0], ref["grads"][0][:n])
    assert torch.equal(got[1], ref["grads"][1][:n])
    again = FB.fused_bwd(pts, lat, ref["w"], *cots)
    assert all(torch.equal(a, b) for a, b in zip([got[0], got[1], *got[2]],
                                                  [again[0], again[1], *again[2]]))


@pytest.mark.cuda
def test_entry_points_split_equals_monolith_past_a_wave_of_ctas(model, cuda_device):
    """At 2 x 132 tiles and a ragged last one, so that every CTA of the
    persistent grids walks more than one tile, the monolith (rows 9 and 10)
    equals the split (rows 7, 1, 2 and 8) bit for bit in value and every
    gradient."""
    m = model.to(cuda_device)
    try:
        pts, lat, _ = _bend_inputs(2 * 132 * 128 + 77, cuda_device, 62)
        mono = _entry_grads(FQ.fused_point_query, m, pts, lat)
        split = _entry_grads(FQ.fused_point_query_split, m, pts, lat)
        torch.cuda.synchronize()
        for a, b in zip(mono[0] + mono[1], split[0] + split[1]):
            assert torch.equal(a, b)
    finally:
        model.to("cpu")


# ---- rows 7 and 8 on mlp_sm90.cuh (csrc/bend_fwd.cu and bend_bwd.cu): the
# persistent grids' edges (one point, a 64-point tile less one, one and two
# tiles, a tile and one, one tile past a wave of two workers a CTA on 132
# SMs, the largest launch: 2^22 forward, 2^18 backward), every size's
# per-point outputs bit for bit the rows of the largest launch, which alone
# is held to the plain version, bit-equal relaunch, the launch counters

SM90_BEND_FWD_SIZES = [0, 1, 63, 64, 128, 129, 132 * 128 + 1, 1 << 22]
SM90_BEND_BWD_SIZES = [0, 1, 63, 64, 128, 129, 132 * 128 + 1, 1 << 18]


@pytest.fixture(scope="module")
def sm90_bend_reference(request):
    """The coarse network's packed bender weights, inputs of each
    direction's largest size and the kernels' outputs on them, held once
    against the plain versions."""
    cache = {}

    def get(device):
        if not cache:
            w = _fused_weights(request.getfixturevalue("model"), device)[:18]
            pts, lat, rng = _bend_inputs(max(SM90_BEND_FWD_SIZES), device, 63)
            out = BF.bend_fwd(pts, lat, w)
            stats = BF.bend_fwd_agreement(out, BF.bend_fwd_plain(pts, lat, w))
            assert stats["ok"], stats
            nb = max(SM90_BEND_BWD_SIZES)
            cots = [torch.from_numpy((s * rng.randn(nb, c)).astype(np.float32)).to(device)
                    for c, s in ((64, 0.1), (3, 1.0), (1, 1.0))]
            got = BB.bend_bwd(pts[:nb], lat[:nb], w, *cots)
            stats = BB.bend_bwd_agreement(
                got, BB.bend_bwd_plain(pts[:nb], lat[:nb], w, *cots))
            assert stats["ok"], stats
            cache.update(w=w, pts=pts, lat=lat, out=out, cots=cots, grads=got)
        return cache

    return get


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_BEND_FWD_SIZES)
def test_bend_fwd_on_the_sm90_kernel_at_the_grid_edges(sm90_bend_reference, cuda_device, n):
    ref = sm90_bend_reference(cuda_device)
    pts, lat = ref["pts"][:n], ref["lat"][:n]
    before = BF.bend_fwd.launches
    out = BF.bend_fwd(pts, lat, ref["w"])
    torch.cuda.synchronize()
    assert BF.bend_fwd.launches == before + (n > 0)
    assert [tuple(t.shape) for t in out] == [(n, 64), (n, 3), (n, 1)]
    assert all(bool(torch.isfinite(t).all()) for t in out)
    for a, b in zip(out, ref["out"]):
        assert torch.equal(a, b[:n])
    assert all(torch.equal(a, b) for a, b in zip(out, BF.bend_fwd(pts, lat, ref["w"])))


@pytest.mark.cuda
@pytest.mark.parametrize("n", SM90_BEND_BWD_SIZES)
def test_bend_bwd_on_the_sm90_kernel_at_the_grid_edges(sm90_bend_reference, cuda_device, n):
    ref = sm90_bend_reference(cuda_device)
    pts, lat = ref["pts"][:n], ref["lat"][:n]
    cots = [c[:n] for c in ref["cots"]]
    before = BB.bend_bwd.launches
    got = BB.bend_bwd(pts, lat, ref["w"], *cots)
    torch.cuda.synchronize()
    assert BB.bend_bwd.launches == before + (n > 0)
    assert got[0].shape == (n, 3) and got[1].shape == (n, 32) and len(got[2]) == 16
    assert all(bool(torch.isfinite(g).all()) for g in got[2])
    assert torch.equal(got[0], ref["grads"][0][:n])
    assert torch.equal(got[1], ref["grads"][1][:n])
    again = BB.bend_bwd(pts, lat, ref["w"], *cots)
    assert all(torch.equal(a, b) for a, b in zip([got[0], got[1], *got[2]],
                                                  [again[0], again[1], *again[2]]))


# ---- the backward past one launch, bf16, serving

PAST_ONE_LAUNCH = (1 << 18) + 129     # a ragged second piece


def _pieced_autograd_case(name, model, model_v, device):
    """(fn(*inputs) -> outputs, per-point inputs, parameters, cotangents,
    the packed weights) of one autograd function at PAST_ONE_LAUNCH points
    on `device`, on a copy of the model there."""
    import copy
    n = PAST_ONE_LAUNCH
    gen = torch.Generator(device=device).manual_seed(21)

    def randn(cols, scale=1.0):
        return scale * torch.randn((n, cols), generator=gen, device=device)

    def uniform(cols):
        return torch.rand((n, cols), generator=gen, device=device) * 2 - 1

    pts = uniform(3) * 0.8
    lat = randn(32, 0.1)
    if name == "mlpv":
        net = copy.deepcopy(model_v.coarse).to(device)
        packed = KV.pack_viewdirs_mlp_weights(net)
        emb, embv = uniform(64), uniform(32)
        emb[:, 63:] = 0
        embv[:, 27:] = 0
        return (lambda e, ev: (KVB.MLPVCore.apply(e, ev, *packed),),
                (emb, embv), list(net.parameters()), (randn(8),), packed)
    m = copy.deepcopy(model).to(device)
    if name in ("mlp", "mlpe"):
        packed = K.pack_mlp_weights(m.fine)
        params = list(m.fine.parameters())
        if name == "mlp":
            emb = uniform(64)
            emb[:, 63:] = 0
            return (lambda e: (KB.MLPCore.apply(e, *packed),), (emb,), params,
                    (randn(8),), packed)
        return (lambda p: (KEB.MLPECore.apply(p, *packed),), (pts,), params,
                (randn(8),), packed)
    if name == "bend":
        packed = BF.pack_bend_weights(m.bender)
        return (lambda p, la: BB.BendCore.apply(p, la, *packed), (pts, lat),
                list(m.bender.parameters()),
                (randn(64, 0.1), randn(3), randn(1)), packed)
    packed = FQ.pack_fused_weights(m, network="fine")
    return (lambda p, la: FB.FusedCore.apply(p, la, *packed), (pts, lat),
            list(m.bender.parameters()) + list(m.fine.parameters()),
            (randn(8), randn(3), randn(1)), packed)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["mlp", "mlpv", "mlpe", "bend", "fused"])
def test_autograd_functions_take_a_backward_past_one_launch(
        model, model_v, cuda_device, name):
    """Each autograd function's backward at 2^18 + 129 points: two pieces,
    two launches, bit-equal on relaunch; and the kernels in those pieces
    against the plain versions in the same pieces, within the backward's
    tolerances."""
    from nonrigid_nerf_torch.ops.kernels.pieces import backward_in_pieces
    fn, inputs, params, cots, packed = _pieced_autograd_case(
        name, model, model_v, cuda_device)
    wrapper, plain, agree, cast = {
        "mlp": (KB.mlp_bwd, KB.mlp_bwd_plain, KB.bwd_agreement,
                K.cast_mlp_weights),
        "mlpv": (KVB.mlpv_bwd, KVB.mlpv_bwd_plain, KVB.bwd_agreement,
                 KV.cast_mlpv_weights),
        "mlpe": (KEB.mlpe_bwd, KEB.mlpe_bwd_plain, KEB.bwd_agreement,
                 K.cast_mlp_weights),
        "bend": (BB.bend_bwd, BB.bend_bwd_plain, BB.bend_bwd_agreement,
                 BF.cast_bend_weights),
        "fused": (FB.fused_bwd, FB.fused_bwd_plain, FB.fused_bwd_agreement,
                  FF.cast_fused_weights)}[name]
    leaves = [t.clone().requires_grad_(True) for t in inputs]
    outs = fn(*leaves)
    before = wrapper.launches
    grads = torch.autograd.grad(outs, leaves + params, cots,
                                retain_graph=True)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 2
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    again = torch.autograd.grad(outs, leaves + params, cots)
    assert all(torch.equal(a, b) for a, b in zip(grads, again))
    w = tuple(t.detach() for t in cast(packed))
    k = len(inputs)
    rows = [t.to(torch.bfloat16) for t in inputs] if name in ("mlp", "mlpv") \
        else list(inputs)
    with torch.no_grad():
        got = backward_in_pieces(
            lambda *r: wrapper(*r[:k], w, *r[k:]), *rows, *cots)
        ref = backward_in_pieces(
            lambda *r: plain(*r[:k], w, *r[k:]), *rows, *cots)
    if name in ("bend", "fused"):
        # the rigidity head's one-channel bias (`rob`): a sum of n
        # cotangent entries that can cancel, held by its error over its
        # own magnitude (bend_bwd.ROB_TOL says why)
        assert BB.rob_rel_err(got[-1], ref[-1]) <= BB.ROB_TOL
        ref = (*ref[:-1], [*ref[-1][:BB.ROB], got[-1][BB.ROB],
                           *ref[-1][BB.ROB + 1:]])
    stats = agree(got, ref)
    assert stats["ok"], stats


@pytest.mark.cuda
def test_bf16_flagship_step_on_cuda_runs_the_kernels(model, cuda_device):
    """compute_dtype="bfloat16" on the card: one flagship training step on a
    small ray batch runs `mlp_fwd` twice and `mlp_bwd` twice (no test
    split), with finite losses and gradients; the bender's products are
    f32 products of bf16-rounded operands, so the step's loss is close to
    the same step at f32 (the same draws)."""
    import dataclasses

    import copy

    from nonrigid_nerf_torch.config import TrainConfig
    from nonrigid_nerf_torch.engine.train_step import losses_and_grads
    m = copy.deepcopy(model).to(cuda_device)
    rs = RenderSettings(N_samples=16, N_importance=16, near=0.1, far=1.6,
                        perturb=1.0, raw_noise_std=1.0)
    tc = TrainConfig(N_rand=64, offsets_loss_weight=60.0,
                     divergence_loss_weight=3.0, rigidity_loss_weight=5e-4)
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    batch = {"rays_o": torch.zeros(64, 3, device=cuda_device),
             "rays_d": torch.cat([0.3 * torch.randn(64, 2, generator=gen,
                                                    device=cuda_device),
                                  -torch.ones(64, 1, device=cuda_device)], 1),
             "target_rgb": torch.rand(64, 3, generator=gen, device=cuda_device),
             "timestep_ids": torch.zeros(64, dtype=torch.int64,
                                         device=cuda_device),
             "train_indicator": torch.ones(64, device=cuda_device),
             "test_indicator": torch.zeros(64, device=cuda_device)}
    results = {}
    for dtype in ("bfloat16", "float32"):
        cfg = dataclasses.replace(CFG, compute_dtype=dtype, N_samples=16,
                                  N_importance=16)
        before = (K.mlp_fwd.launches, KB.mlp_bwd.launches)
        losses, _, grads = losses_and_grads(
            m, 0, batch, cfg=cfg, tc=tc, rs=rs, has_test_split=False,
            n_rand=64, generator=torch.Generator(
                device=cuda_device).manual_seed(4))
        torch.cuda.synchronize()
        assert (K.mlp_fwd.launches, KB.mlp_bwd.launches) == (
            before[0] + 2, before[1] + 2)
        assert bool(torch.isfinite(losses).all())
        assert all(bool(torch.isfinite(g).all()) for g in grads.values())
        results[dtype] = float(losses.mean())
    assert abs(results["bfloat16"] - results["float32"]) <= \
        0.05 * abs(results["float32"])
    assert results["bfloat16"] != results["float32"]     # bf16 ran


@pytest.mark.cuda
def test_bf16_bender_on_cuda_is_the_cpu_dense_apply(model, cuda_device):
    """The bender's offsets and mask at compute_dtype="bfloat16" on the
    card against the CPU (whose `dense_apply` tests/test_torch_bf16.py holds
    bitwise against JAX's) on the same weights, every bias drawn at random:
    at most 1e-2 of the entries not bit-equal and 1e-3 beyond one bf16 ulp
    (the f32 sums run in another order; a rounding before the bias moves
    0.15-0.25 of them past one ulp)."""
    import copy
    gen = torch.Generator().manual_seed(6)
    bender = copy.deepcopy(model.bender).cpu()
    with torch.no_grad():
        for layer in (*bender.bend, *bender.rigidity):
            if layer.bias is not None:
                layer.bias.uniform_(-layer.in_features ** -0.5,
                                    layer.in_features ** -0.5, generator=gen)
    pts = 2 * torch.rand(8192, 3, generator=gen) - 1
    lat = 0.1 * torch.randn(8192, CFG.ray_bending_latent_size, generator=gen)
    on_card = copy.deepcopy(bender).to(cuda_device)
    with torch.no_grad():
        _, want = bender(pts, lat, compute_dtype=torch.bfloat16)
        _, got = on_card(pts.to(cuda_device), lat.to(cuda_device),
                         compute_dtype=torch.bfloat16)
    for key in ("unmasked_offsets", "rigidity_mask"):
        g, w = got[key].cpu().double(), want[key].double()
        ulp = torch.exp2(torch.floor(torch.log2(
            w.abs().clamp_min(torch.finfo(torch.float32).tiny))) - 7)
        assert float((g != w).double().mean()) <= 1e-2, key
        assert float(((g - w).abs() > ulp).double().mean()) <= 1e-3, key


@pytest.mark.cuda
def test_cuda_serving_artifact_equals_the_live_renderer(model, cuda_device,
                                                        tmp_path):
    from nonrigid_nerf_torch import serving
    rs = RenderSettings(N_samples=16, N_importance=16, near=0.1, far=1.6)
    blob, meta = serving.export_renderer(model, CFG, rs, chunk=256,
                                         device=cuda_device)
    assert meta["device"] == "cuda"
    path = str(tmp_path / "m.pt2")
    serving.save_exported(path, blob, meta)
    render, _ = serving.load_exported(path)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    ro = torch.zeros(256, 3, device=cuda_device)
    rd = torch.cat([0.3 * torch.randn(256, 2, generator=gen,
                                      device=cuda_device),
                    -torch.ones(256, 1, device=cuda_device)], 1)
    lat = torch.zeros(256, 32, device=cuda_device)
    got = render(ro, rd, lat)
    import copy
    live = serving.make_serving_fn(copy.deepcopy(model).to(cuda_device), CFG,
                                   rs)(ro, rd, lat)
    assert all(torch.equal(got[k], live[k]) for k in live)
