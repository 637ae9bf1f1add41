"""Framework ops: rays, encoding, sampling, compositing, math."""

from nonrigid_nerf_torch.ops.compositing import raw2outputs
from nonrigid_nerf_torch.ops.embedding import fourier_embed
from nonrigid_nerf_torch.ops.math import img2mse, mse2psnr, safe_norm, to8b
from nonrigid_nerf_torch.ops.rays import get_rays, ndc_rays, pixel_rays
from nonrigid_nerf_torch.ops.sampling import sample_pdf, stratified_z_vals

__all__ = [
    "fourier_embed", "get_rays", "pixel_rays", "ndc_rays",
    "stratified_z_vals", "sample_pdf", "raw2outputs",
    "img2mse", "mse2psnr", "to8b", "safe_norm",
]
