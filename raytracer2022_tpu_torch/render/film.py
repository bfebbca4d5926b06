"""Film: tone mapping and image output (PyTorch).

Counterpart of ``raytracer2022_tpu/render/film.py`` (reference
``write_color``, raytracer/src/main.rs:280-299): NaN scrub on the
per-pixel sum, divide by spp, gamma 2, clamp to [0, 0.999], scale by
255.999, floor to u8; rows are flipped (main.rs:193-198).

``save_image`` writes JPEG (quality 100) and PNG through the port's own
codec, ``utils/imageio.py``.
"""

from __future__ import annotations

import torch

from ..utils.imageio import write_image


def tonemap_u8(color_sum: torch.Tensor, spp: int) -> torch.Tensor:
    """(3, H, W) radiance sum -> u8[H, W, 3] in image orientation."""
    c = torch.nan_to_num(color_sum, nan=0.0, posinf=0.0, neginf=0.0)
    c = torch.sqrt(c / float(spp))
    c = torch.clamp(c, 0.0, 0.999) * 255.999
    img = torch.floor(c).to(torch.uint8).permute(1, 2, 0)  # (H, W, 3)
    return torch.flip(img, dims=(0,))  # vertical flip (main.rs:196)


def linear_image(color_sum: torch.Tensor, spp: int) -> torch.Tensor:
    """(3, H, W) radiance sum -> linear mean (3, H, W), NaN-scrubbed, flipped."""
    c = torch.nan_to_num(color_sum, nan=0.0, posinf=0.0, neginf=0.0) / float(spp)
    return torch.flip(c, dims=(1,))


def save_image(path: str, img_u8) -> None:
    """Write a u8[H, W, 3] image: JPEG quality 100 (like main.rs:213-221)
    for ``.jpg``/``.jpeg``, PNG for ``.png``."""
    if isinstance(img_u8, torch.Tensor):
        img_u8 = img_u8.cpu().numpy()
    write_image(path, img_u8)
