"""Traffic of kind "train": a closed loop of training steps through
`make_train_step`, called as `apps/train.py:train` calls it (the step's
generator from `step_generator(seed, step)`), on the device-resident stack.

Set-up builds the one train state from the benchmark's weights and drives
it through the first `check_steps` steps, whose losses, first gradient
(read back from Adam's first moment) and parameter change the reference
follows; the window goes on with the same state.

The comparison (`check`): the reference takes the first `check_steps`
steps itself from the benchmark's weights, with the same pixels and draws,
in the precision the configuration states (`ref.mlp_dtype`). Compared are
- `loss`: the largest relative gap of a step's loss;
- `grad`: the largest gap of a leaf's norm of the first gradient,
  |‖g‖ - ‖g_ref‖|, over the larger of the reference leaf's norm and the
  median leaf's;
- `change`: the same for the leaves' change over the checked steps, among
  the leaves whose first reference gradient is at least a thousandth of
  the median leaf's (a smaller one is rounding, which Adam would move by
  a full step);
- `head_grad`: the largest ‖g - g_ref‖ / max(‖g_ref‖, median leaf
  ‖g_ref‖) of the first gradient over the canonical MLPs' output-layer
  weights. Their gradient is one product of the MLP's last activation and
  the incoming cotangent, so it reads the products' precision, where the
  norm gaps above read the noise of sums over random-signed rays (PERF.md,
  "How correct is decided").
"""

from __future__ import annotations

import statistics
import time

import torch

from benchmark.harness import cells, checks, faults, inputs

FAULTS = {"frozen": faults.frozen, "half_batch": faults.half_batch}


def run(cell: dict, seed: int, seconds: float, trace: bool, device,
        t0: float, ref) -> cells.Run:
    from nonrigid_nerf_torch.config import RenderSettings, TrainConfig
    from nonrigid_nerf_torch.data.dataset import RayDataset
    from nonrigid_nerf_torch.engine.train_state import (TrainState,
                                                        zero_moments)
    from nonrigid_nerf_torch.engine.train_step import (make_train_step,
                                                       step_generator)
    config, traffic = cell["config"], cell["traffic"]
    train = config["train"]
    out = cells.Run("train", config, traffic, cells.device_name(device),
                    rays_per_unit=traffic["N_rand"])
    stack = inputs.make_stack(traffic["stack"], seed, device)
    n_img, h, w = stack["images"].shape[:3]
    weights = inputs.make_weights(config, n_img, seed, device)
    n_check = traffic["check_steps"]
    cfg = cells.program_config(config)
    tc = TrainConfig(lrate=train["lrate"], lrate_decay=train["lrate_decay"],
                     N_iters=train["N_iters"], N_rand=traffic["N_rand"],
                     warmup_steps=train["warmup_steps"],
                     offsets_loss_weight=train["offsets_loss_weight"],
                     divergence_loss_weight=train["divergence_loss_weight"],
                     rigidity_loss_weight=train["rigidity_loss_weight"],
                     seed=seed)
    rs = RenderSettings(N_samples=cfg.N_samples, N_importance=cfg.N_importance,
                        perturb=train["perturb"],
                        raw_noise_std=train["raw_noise_std"],
                        near=stack["near"], far=stack["far"])
    focal = stack["focal"]
    ds = RayDataset(
        images=stack["images"], poses=stack["poses"],
        view_intrinsics=torch.tensor([[focal, focal, w / 2.0, h / 2.0]],
                                     device=device),
        imageid_to_viewid=torch.zeros(n_img, dtype=torch.int64, device=device),
        imageid_to_timestepid=stack["timestep"],
        train_indicator=torch.ones(n_img, device=device),
        test_indicator=torch.zeros(n_img, device=device),
        height=h, width=w, num_timesteps=n_img, near=stack["near"],
        far=stack["far"])
    model = cells.program_model(cfg, weights, n_img, device)
    state = TrainState(model=model, mu=zero_moments(model),
                       nu=zero_moments(model), step=0)
    step_fn = make_train_step(cfg, tc, rs, has_test_split=False)

    def step():
        return step_fn(state, ds, step_generator(seed, state.step, device))

    losses, first_grad = [], None
    for i in range(n_check):
        losses.append(step()["loss"])
        if i == 0:
            first_grad = {k: v / (1.0 - train["adam_b1"])
                          for k, v in state.mu.items()}
    after = {k: p.detach().clone() for k, p in state.model.named_parameters()}
    for _ in range(traffic["warmup_steps"]):
        step()
    cells.sync(device)
    setup_peak = cells.peak(device)
    out.setup_s = time.time() - t0
    cells.window(out, step, seconds, trace, traffic["trace_steps"], device)
    losses = [float(x) for x in losses]
    out.memory_peak_bytes = max(setup_peak, out.peak_window_bytes)
    out.attempted = n_check
    del state, model, step_fn, ds, step
    cells.free_program(device)
    check(out, ref, cell["limits"], weights, stack, seed, losses, first_grad,
          after)
    return out


def control(cell: dict, seed: int, device, t0: float, ref) -> cells.Run:
    """The reference in the program's place, one precision below what the
    configuration states, through the first `check_steps` steps: no
    window."""
    config, traffic = cell["config"], cell["traffic"]
    out = cells.Run("train", config, traffic, cells.device_name(device))
    stack = inputs.make_stack(traffic["stack"], seed, device)
    weights = inputs.make_weights(config, traffic["stack"]["images"], seed,
                                  device)
    train = dict(config["train"], near=stack["near"], far=stack["far"])
    with ref.full_f32():
        losses, first_grad, after = ref.train_steps(
            weights, config["model"], train, stack, seed,
            traffic["check_steps"], traffic["N_rand"],
            mlp_dtype=ref.mlp_dtype(config, control=True))
    out.attempted = traffic["check_steps"]
    check(out, ref, cell["limits"], weights, stack, seed, losses, first_grad,
          after)
    return out


def check(run, ref, limits, weights, stack, seed, losses, first_grad, after):
    config, traffic = run.config, run.traffic
    train = dict(config["train"], near=stack["near"], far=stack["far"])
    with ref.full_f32():
        ref_losses, ref_grad, ref_after = ref.train_steps(
            weights, config["model"], train, stack, seed,
            len(losses), traffic["N_rand"], mlp_dtype=ref.mlp_dtype(config))
    gnorm = {k: float(torch.linalg.norm(g)) for k, g in ref_grad.items()}
    med = statistics.median(gnorm.values())
    moved = [k for k in ref_grad if gnorm[k] >= 1e-3 * med]
    change = {k: after[k] - weights[k] for k in moved}
    ref_change = {k: ref_after[k] - weights[k] for k in moved}
    grad_gaps = checks.leaf_gaps(first_grad, ref_grad, list(ref_grad))
    grad_diffs = checks.leaf_diffs(first_grad, ref_grad)
    heads = [k for k in ref_grad if k.endswith(".output.weight")]
    change_gaps = checks.leaf_gaps(change, ref_change, moved)
    run.detail = {"losses": losses, "ref_losses": ref_losses,
                  "grad": grad_gaps, "change": change_gaps,
                  "grad_diffs": grad_diffs, "grad_norm": gnorm}
    numbers = {
        "loss": checks.worst(abs(a - b) / abs(b)
                             for a, b in zip(losses, ref_losses)),
        "grad": checks.worst(grad_gaps.values()),
        "head_grad": checks.worst(grad_diffs[k] for k in heads),
        "change": checks.worst(change_gaps.values())}
    checks.finish(run, numbers, limits)
