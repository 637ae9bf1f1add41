"""Image files of the port, through Pillow.

The JAX package reads and writes PNG and JPEG files with imageio
(nonrigid_nerf_tpu/data/llff.py:24-29, apps/render_path.py:102-119), whose
plugin for both formats is Pillow. The GPU machine has Pillow and no
imageio, so the port calls Pillow itself: the same decoder gives the same
arrays. Pillow is imported on first use, not with this module.
"""

from __future__ import annotations

import numpy as np


def imread(path: str) -> np.ndarray:
    """The image at `path` as a numpy array: (H, W) for gray, (H, W, C)
    otherwise, in the file's own bit depth. Palette images become RGB (RGBA
    where the palette has transparency), as imageio returns them."""
    from PIL import Image
    with Image.open(path) as img:
        if img.mode == "P":
            img = img.convert("RGBA" if "transparency" in img.info else "RGB")
        return np.asarray(img)


def imwrite(path: str, image) -> None:
    """Write an (H, W) or (H, W, 3|4) uint8 array; the format follows the
    file's extension."""
    from PIL import Image
    image = np.asarray(image)
    if image.dtype != np.uint8:
        raise ValueError(f"imwrite takes uint8 images, not {image.dtype} "
                         f"({path})")
    Image.fromarray(image).save(path)
