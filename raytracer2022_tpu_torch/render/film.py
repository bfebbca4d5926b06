"""Film: tone mapping and image output (PyTorch).

Counterpart of ``raytracer2022_tpu/render/film.py`` (reference
``write_color``, raytracer/src/main.rs:280-299): NaN scrub on the
per-pixel sum, divide by spp, gamma 2, clamp to [0, 0.999], scale by
255.999, floor to u8; rows are flipped (main.rs:193-198).

``save_image`` writes PNG with numpy and the standard library's ``zlib``;
only ``.jpg`` needs Pillow.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


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


def _png_bytes(arr: np.ndarray) -> bytes:
    """8-bit RGB PNG: IHDR, one zlib IDAT of filter-0 rows, IEND."""
    h, w, _ = arr.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = np.concatenate([np.zeros((h, 1), np.uint8), arr.reshape(h, w * 3)], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit RGB
    return (
        b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", ihdr)
        + chunk(b"IDAT", zlib.compress(raw.tobytes(), 6)) + chunk(b"IEND", b"")
    )


def save_image(path: str, img_u8) -> None:
    """Write a u8[H, W, 3] image: PNG for ``.png``, JPEG quality 100 (like
    main.rs:213-221) for ``.jpg``/``.jpeg``, which needs Pillow."""
    if isinstance(img_u8, torch.Tensor):
        img_u8 = img_u8.cpu().numpy()
    arr = np.ascontiguousarray(img_u8, dtype=np.uint8)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"save_image expects u8[H, W, 3], got {arr.shape}")
    lower = path.lower()
    if lower.endswith(".png"):
        with open(path, "wb") as f:
            f.write(_png_bytes(arr))
    elif lower.endswith((".jpg", ".jpeg")):
        try:
            from PIL import Image
        except ImportError as e:
            raise ImportError(
                f"writing {path!r} needs Pillow, which is not installed; use a .png path"
            ) from e
        Image.fromarray(arr, mode="RGB").save(path, quality=100)
    else:
        raise ValueError(f"unsupported image extension: {path!r} (use .png or .jpg)")
