"""Faults planted in the timed path, for the tests that see `correct` come
out false and for the readings that set a training number's upper limit.
Each is a context manager that patches the program in this process only:

- "frozen": the training step returns its state unchanged (no Adam
  update);
- "half_batch": the step leaves out half of its batch and takes the mean
  over the rest;
- "stale_frame": the renderer hands back its first frame for every frame;
- "altered_pixel": the renderer's first pixel comes back a tenth brighter.
"""

from __future__ import annotations

import contextlib


@contextlib.contextmanager
def _patched(module, name, value):
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, saved)


def frozen():
    from nonrigid_nerf_torch.engine import train_step
    return _patched(train_step, "adam_update", lambda state, grads, tc: None)


def half_batch():
    from nonrigid_nerf_torch.engine import train_step
    body = train_step.train_step_from_batch

    def half(state, batch, **kw):
        n = batch["rays_o"].shape[0] // 2
        kw["n_rand"] = n
        return body(state, {k: v[:n] for k, v in batch.items()}, **kw)

    return _patched(train_step, "train_step_from_batch", half)


def _renderer_fault(change):
    from nonrigid_nerf_torch.apps import render_path
    make = render_path.make_auto_renderer

    def make_faulty(*args, **kwargs):
        render = make(*args, **kwargs)

        def faulty(*a, **k):
            return change(render(*a, **k))

        return faulty

    return _patched(render_path, "make_auto_renderer", make_faulty)


def stale_frame():
    first = {}

    def change(out):
        if not first:
            first.update({k: v.clone() for k, v in out.items()})
        return dict(first)

    return _renderer_fault(change)


def altered_pixel():
    def change(out):
        rgb = out["rgb_map"].clone()
        rgb[0] = rgb[0] + 0.1
        return dict(out, rgb_map=rgb)

    return _renderer_fault(change)


FAULTS = {"frozen": frozen, "half_batch": half_batch,
          "stale_frame": stale_frame, "altered_pixel": altered_pixel}
