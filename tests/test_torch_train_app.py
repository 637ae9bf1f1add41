"""The port's training loop `apps/train.train` on the CPU, at a small size:
it learns, it logs, and a run stopped after a save and started again ends
bit-equal to one that was never stopped."""

import json

import numpy as np
import pytest
import torch

from nonrigid_nerf_torch.apps.train import step_generator, train
from nonrigid_nerf_torch.checkpoints import latest_checkpoint, read_checkpoint
from nonrigid_nerf_torch.config import (ModelConfig, RenderSettings,
                                        TrainConfig)
from nonrigid_nerf_torch.data.dataset import build_ray_dataset

CFG = ModelConfig(netdepth=2, netwidth=32, netdepth_fine=2, netwidth_fine=32,
                  skips=(), multires=4, N_samples=8, N_importance=8,
                  bending_depth=3, bending_width=16, rigidity_depth=2,
                  rigidity_width=8, ray_bending_latent_size=4,
                  fused_kernel="off")
TC = TrainConfig(N_rand=32, N_iters=20, lrate=5e-3, warmup_steps=10,
                 offsets_loss_weight=60.0, divergence_loss_weight=3.0,
                 rigidity_loss_weight=5e-4, seed=3)
RS = RenderSettings(N_samples=8, N_importance=8, near=2.0, far=6.0,
                    raw_noise_std=1.0)


def make_dataset():
    """Four 10 x 12 frames of one smooth image, two of them test images."""
    n, h, w = 4, 10, 12
    yy, xx = np.meshgrid(np.linspace(0, 1, h), np.linspace(0, 1, w),
                         indexing="ij")
    images = np.stack([np.stack([xx, yy, 0.5 + 0 * xx], -1)] * n).astype(
        np.float32)
    poses = np.tile(np.eye(4, dtype=np.float32)[:3], (n, 1, 1))
    poses[:, 2, 3] = 4.0
    extras = {"imageid_to_viewid": [0] * n,
              "imageid_to_timestepid": list(range(n)),
              "raw_timesteps": list(range(n))}
    return build_ray_dataset(
        images, poses, {0: dict(focal_x=12.0, focal_y=12.0, center_x=6.0,
                                center_y=5.0)},
        extras, [0, 2], [1, 3], 2.0, 6.0, device="cpu")


@pytest.fixture(scope="module")
def dataset():
    return make_dataset()


def _params(state):
    return [p.detach().clone() for p in state.model.parameters()]


def test_resume_from_latest_is_bit_equal_to_an_uninterrupted_run(
        dataset, tmp_path, capsys):
    whole = train(CFG, TC, RS, dataset, str(tmp_path / "whole"), device="cpu",
                  i_print=5, i_weights=10)
    out = capsys.readouterr().out
    assert "[TRAIN] Iter: 20" in out and "Saved checkpoint" in out
    assert whole.step == 20

    logdir = str(tmp_path / "stopped")
    first = train(CFG, TC, RS, dataset, logdir, device="cpu", i_print=5,
                  i_weights=10, max_steps=10)
    assert first.step == 10
    assert latest_checkpoint(logdir).endswith("latest.npz")
    assert read_checkpoint(latest_checkpoint(logdir))[0] == 10
    resumed = train(CFG, TC, RS, dataset, logdir, device="cpu", i_print=5,
                    i_weights=10)
    assert resumed.step == 20
    for a, b in zip(_params(whole), _params(resumed)):
        assert torch.equal(a, b)
    for name in whole.mu:
        assert torch.equal(whole.mu[name], resumed.mu[name])
        assert torch.equal(whole.nu[name], resumed.nu[name])

    rows = [json.loads(line) for line in
            open(tmp_path / "stopped" / "metrics.jsonl")]
    assert [r["step"] for r in rows] == [5, 10, 15, 20]
    assert {"loss", "psnr", "img_loss", "img_loss0", "offsets_loss",
            "divergence_loss", "it_per_sec"} <= set(rows[0])
    whole_rows = [json.loads(line) for line in
                  open(tmp_path / "whole" / "metrics.jsonl")]
    assert [r["loss"] for r in rows] == [r["loss"] for r in whole_rows]
    extras = read_checkpoint(latest_checkpoint(logdir))[2]
    assert extras == {"near": 2.0, "far": 6.0}


def test_training_lowers_the_loss_and_no_reload_starts_afresh(dataset,
                                                              tmp_path):
    tc = TrainConfig(**{**TC.__dict__, "N_iters": 150})
    logdir = str(tmp_path / "run")
    state = train(CFG, tc, RS, dataset, logdir, device="cpu", i_print=25,
                  i_weights=150)
    rows = [json.loads(line) for line in open(tmp_path / "run" / "metrics.jsonl")]
    assert rows[-1]["img_loss"] < 0.7 * rows[0]["img_loss"]
    assert all(torch.isfinite(p).all() for p in state.model.parameters())
    assert float(state.model.latents.detach().abs().max()) > 0
    again = train(CFG, tc, RS, dataset, logdir, device="cpu", i_print=25,
                  i_weights=150, no_reload=True, max_steps=1)
    assert again.step == 1


def test_step_generator_depends_on_seed_and_step_only():
    a = torch.rand(4, generator=step_generator(3, 7, "cpu"))
    assert torch.equal(a, torch.rand(4, generator=step_generator(3, 7, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(3, 8, "cpu")))
    assert not torch.equal(a, torch.rand(4, generator=step_generator(4, 7, "cpu")))


def test_train_defaults_to_cuda_and_checks_the_dataset_device(dataset,
                                                              tmp_path,
                                                              monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train(CFG, TC, RS, dataset, str(tmp_path))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="the dataset is on"):
        train(CFG, TC, RS, dataset, str(tmp_path))
