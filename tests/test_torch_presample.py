"""The presampled step (`engine/train_step.py:make_prefetch_train_step`,
counterpart of the JAX package's `make_prefetch_train_step`) on the CPU.

- N presampled steps are bit-equal to N plain steps in losses and
  parameters: the same pixels and the same further random numbers, across a
  window boundary and across a resume in the middle of a window.
- `presample_fn` makes every window's rays in one pass (one gather from the
  image stack), and its generators stand where the plain step's stand after
  its pixel draw.
- The CLI's rule for `--sampling_prefetch`: N > 1 presamples N steps a
  window; 0, 1 and -1 run the plain step. JAX's -1 presamples 64 on a
  stack of 256 MB or more (train.py:268-273); the port keeps the plain step
  there, which was faster on an H100.
"""

import dataclasses
import json

import torch

from nonrigid_nerf_torch.apps.train import resolve_sampling_prefetch, train
from nonrigid_nerf_torch.data import dataset as t_dataset
from nonrigid_nerf_torch.engine import train_step as t_step
from nonrigid_nerf_torch.engine.train_state import create_train_state
from tests.test_torch_train_app import CFG, RS, TC, _params, make_dataset


def _rows(path):
    return [json.loads(line) for line in open(path)]


def test_presampled_training_is_bit_equal_across_windows_and_a_resume(
        tmp_path, capsys):
    ds = make_dataset()
    tc = dataclasses.replace(TC, N_iters=11)
    plain = train(CFG, tc, RS, ds, str(tmp_path / "plain"), device="cpu",
                  i_print=1, i_weights=100)
    logdir = str(tmp_path / "pre")
    # windows of 4 steps from step 0; stopped after step 6, in the middle
    # of the window from step 4, and resumed with a window from step 6
    first = train(CFG, tc, RS, ds, logdir, device="cpu", i_print=1,
                  i_weights=6, max_steps=6, sampling_prefetch=4)
    assert first.step == 6
    resumed = train(CFG, tc, RS, ds, logdir, device="cpu", i_print=1,
                    i_weights=100, sampling_prefetch=4)
    assert resumed.step == 11
    assert "presampled training: 4 batches per stack pass" in \
        capsys.readouterr().out
    for a, b in zip(_params(plain), _params(resumed)):
        assert torch.equal(a, b)
    for name in plain.mu:
        assert torch.equal(plain.mu[name], resumed.mu[name])
        assert torch.equal(plain.nu[name], resumed.nu[name])
    strip = [{k: v for k, v in r.items() if k != "it_per_sec"}
             for r in _rows(tmp_path / "plain" / "metrics.jsonl")]
    got = [{k: v for k, v in r.items() if k != "it_per_sec"}
           for r in _rows(tmp_path / "pre" / "metrics.jsonl")]
    assert [r["step"] for r in got] == list(range(1, 12))
    assert got == strip


def test_presample_gathers_once_and_leaves_each_generator_after_its_pixels(
        monkeypatch):
    ds = make_dataset()
    presample_fn, step_fn = t_step.make_prefetch_train_step(
        CFG, TC, RS, has_test_split=ds.has_test_split, n_prefetch=3)
    calls = []
    orig = t_step.sample_ray_batch
    monkeypatch.setattr(t_step, "sample_ray_batch", lambda *a, **k: (
        calls.append(a[1]), orig(*a, **k))[1])
    batches = presample_fn(ds, TC.seed, 5)
    assert calls == [3 * TC.N_rand]
    for i in range(3):
        gen = t_step.step_generator(TC.seed, 5 + i, "cpu")
        want = orig(ds, TC.N_rand, generator=gen)
        for k, v in want.items():
            assert torch.equal(batches["rays"][k][i * TC.N_rand:
                                                  (i + 1) * TC.N_rand], v), k
        # the presampled generator stands where the plain step's does
        assert torch.equal(batches["generators"][i].get_state(),
                           gen.get_state())
    # one step from the batches equals one plain step
    a = create_train_state(CFG, TC, ds.num_timesteps, device="cpu")
    b = create_train_state(CFG, TC, ds.num_timesteps, device="cpu")
    a.step = b.step = 5
    ma = step_fn(a, batches, 0)
    mb = t_step.make_train_step(CFG, TC, RS, ds.has_test_split)(
        b, ds, t_step.step_generator(TC.seed, 5, "cpu"))
    assert all(torch.equal(ma[k], mb[k]) for k in mb)
    assert all(torch.equal(x, y) for x, y in zip(_params(a), _params(b)))


def test_sampling_prefetch_auto_rule():
    small = make_dataset()
    assert [resolve_sampling_prefetch(n) for n in (-1, 0, 1, 2, 16, 64)] == \
        [0, 0, 0, 2, 16, 64]
    assert t_dataset.draw_pixels(small, 5, torch.Generator().manual_seed(0))[
        0].shape == (5,)
