"""LPIPS (AlexNet) of the evaluation protocol in PyTorch
(counterpart of nonrigid_nerf_tpu/utils/lpips_jax.py).

The reference computes LPIPS through a cloned PerceptualSimilarity repo and
a pretrained torch AlexNet (reference: free_viewpoint_rendering.py:790-797,
846-855). Here the whole pipeline (AlexNet's conv features, unit-normalized
channels, the learned non-negative 1 x 1 weights, the spatial mean) is
computed with torch.nn.functional on the CPU; only the weights are
external, one `.npz` file with the JAX package's schema (`weight_spec()`),
which tools/convert_lpips_weights.py writes from the `lpips` package.

Where the weights are looked for, in order:
  1. `$NRN_LPIPS_WEIGHTS` (the path of the npz)
  2. `<repo>/data/lpips_alex.npz`
  3. `~/.cache/nonrigid_nerf_tpu/lpips_alex.npz`

Pipeline (lpips.LPIPS(net='alex')):
  x in [0,1] -> 2x-1 -> (x - shift)/scale -> AlexNet relu1..relu5 features
  -> unit-normalize channels -> squared difference -> 1x1 linear (non-neg
  weights) -> spatial mean -> sum over the 5 taps.
"""

from __future__ import annotations

import functools
import os
from typing import Dict, Optional

import numpy as np

# AlexNet's `features` trunk (torchvision's layout). Each tap is the
# activation after the listed ReLU; a pool belongs to the FOLLOWING slice,
# as in the lpips package's slice1..slice5.
_CONVS = (
    # (out_ch, in_ch, kernel, stride, pad, maxpool_before)
    (64, 3, 11, 4, 2, False),
    (192, 64, 5, 1, 2, True),
    (384, 192, 3, 1, 1, True),
    (256, 384, 3, 1, 1, False),
    (256, 256, 3, 1, 1, False),
)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)


def weight_spec():
    """The npz schema: conv{i}_w (O,I,kh,kw) OIHW, conv{i}_b (O,),
    lin{i}_w (C_i,) for i in 0..4."""
    spec = {}
    for i, (out_ch, in_ch, k, _, _, _) in enumerate(_CONVS):
        spec[f"conv{i}_w"] = (out_ch, in_ch, k, k)
        spec[f"conv{i}_b"] = (out_ch,)
        spec[f"lin{i}_w"] = (out_ch,)
    return spec


def _candidate_paths():
    env = os.environ.get("NRN_LPIPS_WEIGHTS")
    if env:
        yield env
    repo = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    yield os.path.join(repo, "data", "lpips_alex.npz")
    yield os.path.join(os.path.expanduser("~"), ".cache",
                       "nonrigid_nerf_tpu", "lpips_alex.npz")


def load_weights(path: Optional[str] = None) -> Optional[Dict[str, np.ndarray]]:
    """Load and check the LPIPS weight npz; None when there is none."""
    paths = [path] if path else list(_candidate_paths())
    for p in paths:
        if p and os.path.exists(p):
            with np.load(p) as data:
                weights = {k: np.asarray(data[k], np.float32)
                           for k in data.files}
            for key, shape in weight_spec().items():
                if key not in weights or weights[key].shape != shape:
                    raise ValueError(
                        f"{p}: bad LPIPS weight file — {key} should have "
                        f"shape {shape}, got "
                        f"{weights.get(key) is not None and weights[key].shape}")
            return weights
    return None


def _alexnet_taps(x, weights):
    """x: (N, 3, H, W), already shifted and scaled. The 5 ReLU taps."""
    import torch.nn.functional as F
    taps = []
    h = x
    for i, (_, _, _, stride, pad, pool_before) in enumerate(_CONVS):
        if pool_before:
            h = F.max_pool2d(h, kernel_size=3, stride=2)
        h = F.relu(F.conv2d(h, weights[f"conv{i}_w"], weights[f"conv{i}_b"],
                            stride=stride, padding=pad))
        taps.append(h)
    return taps


def _lpips_pair(img_a, img_b, weights):
    """img_*: (H, W, 3) float32 tensors in [0, 1]. The distance, a 0-d
    tensor."""
    import torch
    shift = torch.from_numpy(_SHIFT)
    scale = torch.from_numpy(_SCALE)

    def prep(img):
        x = 2.0 * img - 1.0                                  # [-1, 1]
        x = (x - shift) / scale
        return x.permute(2, 0, 1)[None]                      # (1, 3, H, W)

    taps_a = _alexnet_taps(prep(img_a), weights)
    taps_b = _alexnet_taps(prep(img_b), weights)

    def unit_norm(f):
        norm = torch.sqrt(torch.sum(torch.square(f), dim=1, keepdim=True))
        return f / (norm + 1e-10)

    total = torch.zeros(())
    for i, (fa, fb) in enumerate(zip(taps_a, taps_b)):
        diff = torch.square(unit_norm(fa) - unit_norm(fb))   # (1, C, H, W)
        lin = weights[f"lin{i}_w"][None, :, None, None]
        total = total + torch.mean(torch.sum(diff * lin, dim=1))
    return total


@functools.lru_cache(maxsize=1)
def _get_model():
    """The weights as CPU tensors, or None when no weight file exists."""
    weights = load_weights()
    if weights is None:
        return None
    import torch
    return {k: torch.from_numpy(v) for k, v in weights.items()}


def lpips_available() -> bool:
    return _get_model() is not None


def reset_cache() -> None:
    """Forget the cached weight file (for tests, or after installing it)."""
    _get_model.cache_clear()


def _pipeline_supports(h: int, w: int) -> bool:
    """Whether the AlexNet trunk gives non-empty activations for an (h, w)
    image: every conv's and pool's output stays at least 1 wide."""
    def ok(d):
        for (_, _, k, stride, pad, pool_before) in _CONVS:
            if pool_before:
                if d < 3:
                    return False
                d = (d - 3) // 2 + 1
            d = (d + 2 * pad - k) // stride + 1
            if d < 1:
                return False
        return True
    return ok(h) and ok(w)


def lpips_alex(groundtruth: np.ndarray,
               generated: np.ndarray) -> Optional[float]:
    """LPIPS (AlexNet) distance of two (H, W, 3) images in [0, 1], or None
    when no weight file is installed or the images are smaller than the
    trunk needs (about 31 px a side)."""
    weights = _get_model()
    if weights is None:
        return None
    h, w = np.asarray(groundtruth).shape[:2]
    if not _pipeline_supports(h, w):
        print(f"lpips: image {h}x{w} too small for the AlexNet trunk; "
              "skipping", flush=True)
        return None
    import torch
    a = torch.from_numpy(np.asarray(groundtruth, np.float32))
    b = torch.from_numpy(np.asarray(generated, np.float32))
    with torch.no_grad():
        return float(_lpips_pair(a, b, weights))
