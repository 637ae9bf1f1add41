"""Traffic of kind "train" for a view-direction configuration: the loop and
the control of `train.py` (its `FAULTS`, loaded by path), with two
differences: the weights carry the view heads (`harness/inputs_views.py`),
and the run records the `mlpv_fwd` and `mlpv_bwd` launches of its traced
steps (without a trace, of its window) in `run.counters`
(`harness/cells_views.py:LaunchLog`). Two faults more: "straight_viewdirs",
the unbent ray's directions, and "detached_viewdirs", the bent ray's
directions cut from the autograd graph (`harness/cells_views.py`).

The comparison is `train.py`'s (`loss`, `grad`, `change`, `head_grad`),
with three differences:
- `head_grad` reads this architecture's output layers, the density head
  `alpha` and the `rgb` head, each one product of its input activation and
  the incoming cotangent (`train.py`'s `check` reads the `output` layer,
  which this architecture has not);
- `grad` and `change` read the canonical MLPs' leaves;
- `bender_dirs` reads the other leaves, the bender's, the rigidity
  network's and the latents', on the term that this architecture adds to
  their gradient: the one through the bent-ray directions. The reference
  takes the first step's gradient once more with the directions cut from
  the graph (`directions_cut`), and for each leaf the program's gap to the
  reference is projected on that term: |<g - g_ref, g_cut - g_ref>| /
  ‖g_cut - g_ref‖², the share of the term that the program misses (0 where
  it follows the reference, 1 without the term); `bender_dirs` is its
  median over those leaves. The term is about a hundredth of those leaves'
  gradient, no more than the roundings of the stated precision, so a gap
  of the whole gradient would not see it. The gaps stay in the run's
  detail: `bender_grad`, the median over those leaves of ‖g - g_ref‖ /
  max(‖g_ref‖, the median of those leaves' ‖g_ref‖); `grad_bender` and
  `change_bender`, the worst leaf's `grad` and `change` gaps. Those worst
  leaves are not held: a direction's Jacobian is 1 / (|x'_i - x'_{i-1}| +
  1e-6), and where two consecutive samples nearly coincide (depth gaps
  under 1e-4 occur among a batch's rays) it multiplies a rounding of the
  incoming cotangent by 1e4 or more, so that on a few seeds one leaf reads
  a gap far above the others', which the same seed reproduces and which
  goes with the f32 products or with those differences cut on both sides
  (PERF.md).
"""

from __future__ import annotations

import math
import os
import statistics
import time

import torch

from benchmark.harness import (cells, cells_views, checks, inputs,
                               inputs_views, spec)

base = spec.load(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                              "train.py"))
FAULTS = dict(base.FAULTS, straight_viewdirs=cells_views.straight_viewdirs,
              detached_viewdirs=cells_views.detached_viewdirs)
HEADS = (".alpha.weight", ".rgb.weight")
MLPS = ("coarse.", "fine.")


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
    weights = inputs_views.make_weights(config, n_img, seed, device)
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
    log = cells_views.LaunchLog()
    cells.window(out, log.counted(step), seconds, trace,
                 traffic["trace_steps"], device)
    log.record(out, trace)
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
    weights = inputs_views.make_weights(config, traffic["stack"]["images"],
                                        seed, device)
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
    heads = [k for k in ref_grad if k.endswith(HEADS)]
    bender = [k for k in ref_grad if not k.startswith(MLPS)]
    bender_diffs = list(checks.leaf_diffs(
        {k: first_grad[k] for k in bender},
        {k: ref_grad[k] for k in bender}).values())
    with ref.full_f32(), ref.directions_cut():
        _, cut_grad, _ = ref.train_steps(
            weights, config["model"], train, stack, seed, 1,
            traffic["N_rand"], mlp_dtype=ref.mlp_dtype(config))
    missed = {k: missed_share(first_grad[k], ref_grad[k], cut_grad[k])
              for k in bender}
    change_gaps = checks.leaf_gaps(change, ref_change, moved)
    run.detail = {"losses": losses, "ref_losses": ref_losses,
                  "grad": grad_gaps, "change": change_gaps,
                  "grad_diffs": grad_diffs, "grad_norm": gnorm,
                  "dirs_missed": missed}

    def worst(gaps, mlp):
        return checks.worst(v for k, v in gaps.items()
                            if k.startswith(MLPS) == mlp)

    numbers = {
        "loss": checks.worst(abs(a - b) / abs(b)
                             for a, b in zip(losses, ref_losses)),
        "grad": worst(grad_gaps, True),
        "head_grad": checks.worst(grad_diffs[k] for k in heads),
        "bender_dirs": median(list(missed.values())),
        "bender_grad": median(bender_diffs),
        "change": worst(change_gaps, True),
        "grad_bender": worst(grad_gaps, False),
        "change_bender": worst(change_gaps, False)}
    checks.finish(run, numbers, limits)


def median(values) -> float:
    """The median, or NaN where any value is NaN."""
    return math.nan if any(math.isnan(v) for v in values) \
        else statistics.median(values)


def missed_share(prog, ref, cut) -> float:
    """|<prog - ref, cut - ref>| / ‖cut - ref‖²: the share of the term
    (ref - cut) that prog misses; NaN where the leaf has no such term."""
    term = (cut - ref).double().flatten()
    norm2 = float(torch.dot(term, term))
    if norm2 == 0.0:
        return math.nan
    return abs(float(torch.dot((prog - ref).double().flatten(), term))) \
        / norm2
