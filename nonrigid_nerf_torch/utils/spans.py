"""Named host spans at the program's stage boundaries, on torch.profiler's
clock.

    with span("adam"):
        ...

    @spanned("stage1")
    def bend_encode_stage(...):
        ...

With no profiler running, `span` returns one shared no-op context manager:
a check of the profiler's flag (about 0.1 us) is all a span costs. Under a
profiler it opens a FUNCTION-scope record range named `nrnerf/<name>`. The
range is a host event on the profiler's clock, so it shares a clock with
the device trace, and it puts no event on the device's timeline
(`record_function`'s user annotations are mirrored there as device events).
The profiler keeps the spans and writes them out with its trace; nothing
here keeps or exports anything.

Names are flat stages, so that a stage adds up across the coarse and fine
passes, training and rendering; the nesting of the ranges gives the tree.
A step's spans nest inside its `step` span, a frame's inside its `frame`
span. Spans that autograd's device thread opens during a backward (the
pieces of a fused backward, `bwd_piece`) lie inside the calling thread's
`backward` span by time.

| Span | Where |
| --- | --- |
| `step` | one training step (`engine/train_step.py`), on every step path |
| `sample` | the pixel draw and the rays of a step |
| `stage1` | `engine/query.py:bend_encode_stage`: bender, rigidity, encoding |
| | (also the sort-first fine pass's encoding of the sorted union) |
| `viewdirs` | `sample_viewdirs` (+ `_embed_views` off the points route), on every route |
| `stage2` | `engine/query.py:canonical_mlp_stage`: the canonical MLP |
| `composite` | each `raw2outputs` of `engine/render.py` |
| `importance` | `sample_pdf`, the importance draws |
| `union` | the fine pass's joins of the coarse and new stage-1 outputs |
| `sort` | the depth sort (`sort_merge`, or the sort before a second query) |
| `losses` | `per_ray_losses`, the divergence jvp included |
| `backward` | each `torch.autograd.grad` of the step |
| `bwd_piece` | each piece of a fused backward (`ops/kernels/pieces.py`) |
| `adam` | `engine/train_state.py:adam_update` |
| `block` | one block of rays of `make_ray_renderer`'s loop |
| `frame` | one pose of `apps/render_path.py:render_path` |
| `frame_rays` | the frame's renderer, rays and host-to-device copies |
| `blocks` | the frame's block loop and its join |
| `readback` | the frame's images copied to the host |
| `write` | the frame's image files |
"""

from __future__ import annotations

import contextlib
import functools

import torch

PREFIX = "nrnerf/"

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager around one stage: a profiler range named
    `nrnerf/<name>` while a profiler runs, else a shared no-op."""
    if not torch.autograd._profiler_enabled():
        return _OFF
    return torch._C._profiler._RecordFunctionFast(PREFIX + name)


def spanned(name: str):
    """Decorator: the whole call runs inside `span(name)`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap
