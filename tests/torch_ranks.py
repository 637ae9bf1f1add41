"""Spawned gloo ranks on the CPU for the tests of the port's data
parallelism (`nonrigid_nerf_torch/parallel/`), and the work each rank does.

This module imports torch, numpy and the port only, never JAX: every rank
is a fresh process (`spawn`) that imports it to find its work, so the
ranks hold the port alone, as they would on the GPUs. The process group
comes up through `multihost.initialize` with a `file://` rendezvous in the
test's own temporary folder, so that concurrent test workers cannot meet
on one TCP port.
"""

import os
import pickle
import time
import traceback

import numpy as np
import torch

from nonrigid_nerf_torch.parallel import multihost

JOIN_TIMEOUT_S = 240


def _rank_main(fn, rank, world, folder, args):
    torch.set_num_threads(1)
    try:
        multihost.initialize(rank, world, f"file://{folder}/rendezvous",
                             device="cpu")
        payload = ("ok", fn(rank, world, *args))
    except BaseException:       # reported to the parent, which raises
        payload = ("error", traceback.format_exc())
    finally:
        if multihost.is_initialized():
            torch.distributed.destroy_process_group()
    with open(os.path.join(folder, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(payload, f)


class Ranks:
    """`world` spawned processes running fn(rank, world, *args) in one
    process group; `results()` waits for them and returns each rank's
    return value, in rank order."""

    def __init__(self, fn, world: int, folder, *args):
        import multiprocessing
        self.folder = str(folder)
        os.makedirs(self.folder, exist_ok=True)
        ctx = multiprocessing.get_context("spawn")
        self.procs = [ctx.Process(target=_rank_main,
                                  args=(fn, r, world, self.folder, args))
                      for r in range(world)]
        for p in self.procs:
            p.start()

    def results(self):
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        for p in self.procs:
            p.join(timeout=max(1.0, deadline - time.monotonic()))
        hung = [r for r, p in enumerate(self.procs) if p.is_alive()]
        for p in self.procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        out, errors = [], []
        for r, p in enumerate(self.procs):
            path = os.path.join(self.folder, f"rank{r}.pkl")
            if not os.path.exists(path):
                errors.append(f"rank {r}: no result (exit code "
                              f"{p.exitcode}{', hung' if r in hung else ''})")
                continue
            with open(path, "rb") as f:
                status, value = pickle.load(f)
            if status != "ok":
                errors.append(f"rank {r}:\n{value}")
            out.append(value)
        if errors:
            raise AssertionError("\n".join(errors))
        return out


def run_ranks(fn, world: int, folder, *args):
    return Ranks(fn, world, folder, *args).results()


# ---- the ranks' work

def _torch_batch(batch):
    return {k: torch.from_numpy(np.array(v)).to(
        torch.int64 if k in ("timestep_ids", "image_ids") else torch.float32)
        for k, v in batch.items()}


def _state(tree, cfg):
    from nonrigid_nerf_torch.engine.train_state import TrainState, zero_moments
    from nonrigid_nerf_torch.weights import params_from_jax
    model = params_from_jax(tree, cfg, device="cpu")
    return TrainState(model=model, mu=zero_moments(model),
                      nu=zero_moments(model), step=0)


def _numpy_params(model):
    from nonrigid_nerf_torch.weights import params_to_jax
    return params_to_jax(model)


def _metrics(metrics):
    return {k: float(v) for k, v in metrics.items()}


def given_batch_steps(rank, world, case):
    """The data-parallel step on given global batches and this rank's
    given draws: metrics after every step, parameters after each step of
    case["keep"]."""
    from nonrigid_nerf_torch.parallel import parallel_train_step_from_batch
    state = _state(case["tree"], case["cfg"])
    metrics, params = [], {}
    for step, (gbatch, draws) in enumerate(zip(case["batches"],
                                               case["draws"])):
        m = parallel_train_step_from_batch(
            state, _torch_batch(gbatch), cfg=case["cfg"], tc=case["tc"],
            rs=case["rs"], has_test_split=True, debug_metrics=True,
            draws={k: torch.from_numpy(np.array(v))
                   for k, v in draws[rank].items()})
        metrics.append(_metrics(m))
        if step + 1 in case["keep"]:
            params[step + 1] = _numpy_params(state.model)
    return {"metrics": metrics, "params": params}


def generator_steps(rank, world, case):
    """`make_parallel_train_step` on the dataset, the generators of
    apps/train.py:step_generator: metrics after every step, the final
    parameters and Adam moments."""
    from nonrigid_nerf_torch.apps.train import step_generator
    from nonrigid_nerf_torch.data.dataset import build_ray_dataset
    from nonrigid_nerf_torch.parallel import make_parallel_train_step
    ds = build_ray_dataset(*case["dataset"], device="cpu")
    state = _state(case["tree"], case["cfg"])
    step_fn = make_parallel_train_step(case["cfg"], case["tc"], case["rs"],
                                       has_test_split=ds.has_test_split)
    metrics = []
    for step in range(case["steps"]):
        metrics.append(_metrics(step_fn(state, ds, step_generator(
            case["tc"].seed, step, "cpu"))))
    return {"metrics": metrics, "params": _numpy_params(state.model),
            "mu": {k: v.numpy() for k, v in state.mu.items()}}


def render(rank, world, case):
    """`make_parallel_renderer` (and `make_auto_renderer`) on given rays:
    every output, as numpy, on this rank."""
    from nonrigid_nerf_torch.parallel import (make_auto_renderer,
                                              make_parallel_renderer)
    from nonrigid_nerf_torch.weights import params_from_jax
    model = params_from_jax(case["tree"], case["cfg"], device="cpu")
    rays = [torch.from_numpy(np.array(a)) for a in case["rays"]]
    out = {}
    for name, make in (("parallel", make_parallel_renderer),
                       ("auto", make_auto_renderer)):
        fn = make(case["cfg"], case["rs"], chunk=case["chunk"], device="cpu")
        out[name] = {k: v.numpy() for k, v in fn(model, *rays).items()}
    return out


def nondividing(rank, world, case):
    """The message of the error that a batch of N_rand rays that does not
    split over the ranks raises, at make time and on a given batch."""
    from nonrigid_nerf_torch.parallel import (make_parallel_train_step,
                                              parallel_train_step_from_batch)
    messages = []
    try:
        make_parallel_train_step(case["cfg"], case["tc"], case["rs"],
                                 has_test_split=False, n_rand=world + 1)
    except ValueError as e:
        messages.append(str(e))
    state = _state(case["tree"], case["cfg"])
    gbatch = _torch_batch({k: v[:world + 1]
                           for k, v in case["batches"][0].items()})
    try:
        parallel_train_step_from_batch(state, gbatch, cfg=case["cfg"],
                                       tc=case["tc"], rs=case["rs"],
                                       has_test_split=False)
    except ValueError as e:
        messages.append(str(e))
    return messages


def all_cases(rank, world, cases):
    """Every case of `cases` ({name: (work, case)}) in one process group,
    in order: {name: result}."""
    return {name: globals()[work](rank, world, case)
            for name, (work, case) in cases.items()}
