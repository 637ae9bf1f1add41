"""Image metrics of the evaluation: PSNR, SSIM, optional LPIPS
(counterpart of nonrigid_nerf_tpu/utils/metrics.py).

The reference's protocol (reference: free_viewpoint_rendering.py:826-876):
PSNR over the whole image; SSIM with Gaussian weights, sigma 1.5, data
range 1 and no sample covariance (skimage's structural_similarity with
those settings); LPIPS (AlexNet) where an implementation is available, else
None. skimage is not installed on either machine, so SSIM is computed here
with its own separable Gaussian filter. Host numpy throughout.
"""

from __future__ import annotations

from typing import Optional

import numpy as np


def psnr(groundtruth: np.ndarray, generated: np.ndarray) -> float:
    mse = np.mean((groundtruth - generated) ** 2)
    return float(-10.0 * np.log10(mse))


def _gaussian_kernel1d(sigma: float, truncate: float = 3.5) -> np.ndarray:
    radius = int(truncate * sigma + 0.5)
    x = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


def _gaussian_filter2d(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable Gaussian blur with replicated edges (numpy's 'edge', which
    is scipy.ndimage's 'nearest', the mode of skimage's SSIM)."""
    k = _gaussian_kernel1d(sigma)
    r = (len(k) - 1) // 2
    padded = np.pad(img, ((r, r), (0, 0)), mode="edge")
    tmp = np.zeros_like(img)
    for i, w in enumerate(k):
        tmp += w * padded[i:i + img.shape[0], :]
    padded = np.pad(tmp, ((0, 0), (r, r)), mode="edge")
    out = np.zeros_like(img)
    for j, w in enumerate(k):
        out += w * padded[:, j:j + img.shape[1]]
    return out


def ssim(groundtruth: np.ndarray, generated: np.ndarray,
         data_range: float = 1.0, sigma: float = 1.5, full: bool = False):
    """Gaussian-weighted SSIM averaged over the channels (skimage's
    structural_similarity(..., gaussian_weights=True, sigma=1.5,
    use_sample_covariance=False, multichannel=True)); with `full` also the
    (H, W, C) map."""
    if groundtruth.ndim == 2:
        groundtruth = groundtruth[..., None]
        generated = generated[..., None]
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2

    vals, maps = [], []
    for c in range(groundtruth.shape[-1]):
        x = groundtruth[..., c].astype(np.float64)
        y = generated[..., c].astype(np.float64)
        mu_x = _gaussian_filter2d(x, sigma)
        mu_y = _gaussian_filter2d(y, sigma)
        mu_xx = _gaussian_filter2d(x * x, sigma)
        mu_yy = _gaussian_filter2d(y * y, sigma)
        mu_xy = _gaussian_filter2d(x * y, sigma)
        var_x = mu_xx - mu_x ** 2
        var_y = mu_yy - mu_y ** 2
        cov = mu_xy - mu_x * mu_y
        s = ((2 * mu_x * mu_y + c1) * (2 * cov + c2)) / (
            (mu_x ** 2 + mu_y ** 2 + c1) * (var_x + var_y + c2))
        # skimage leaves the filter's radius out of the mean at the border;
        # an image under the 11 x 11 window (which skimage refuses) keeps a
        # smaller border, so that the mean stays defined
        r = int(3.5 * sigma + 0.5)
        r = min(r, (s.shape[0] - 1) // 2, (s.shape[1] - 1) // 2)
        vals.append(s[r:s.shape[0] - r, r:s.shape[1] - r].mean())
        maps.append(s)
    mean_val = float(np.mean(vals))
    if full:
        return mean_val, np.stack(maps, -1)
    return mean_val


_lpips_model = None


def lpips_distance(groundtruth: np.ndarray,
                   generated: np.ndarray) -> Optional[float]:
    """LPIPS (AlexNet) of two (H, W, 3) images in [0, 1], or None where no
    implementation is available: first the port's own pipeline
    (`utils/lpips.py`, which needs the `data/lpips_alex.npz` weights), then
    the `lpips` package where it imports (reference:
    free_viewpoint_rendering.py:790-797,846-855)."""
    from nonrigid_nerf_torch.utils.lpips import lpips_alex
    native = lpips_alex(groundtruth, generated)
    if native is not None:
        return native

    global _lpips_model
    try:
        import lpips
    except ImportError:
        return None
    import torch
    if _lpips_model is None:
        _lpips_model = lpips.LPIPS(net="alex")

    def to_torch(img):
        t = 2.0 * torch.from_numpy(img.astype(np.float32)) - 1.0
        return t.permute(2, 0, 1).unsqueeze(0)

    with torch.no_grad():
        d = _lpips_model.forward(to_torch(groundtruth), to_torch(generated))
    return float(d.detach().reshape(-1)[0])
