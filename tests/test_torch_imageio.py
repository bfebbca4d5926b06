"""The port's image codec (``utils/imageio.py``) against Pillow: the JPEG
decoder on files Pillow wrote, the encoder against Pillow's own encode at
quality 100, the modes it refuses, PNG, and scenes and images without
Pillow.

Decoder criterion: at most 1 level from Pillow's decode in any channel and
equal in at least 99% of channels.  Encoder criterion: Pillow's decode of
the port's file is as close to Pillow's decode of Pillow's file, and the
port's file's mean absolute error against the source is at most 1.05 times
Pillow's."""

import io
import struct
import sys
import zlib

import numpy as np
import pytest

from raytracer2022_tpu_torch.utils import imageio

Image = pytest.importorskip("PIL.Image")

MAX_LEVELS = 1
MIN_EQUAL = 0.99
MAX_MAE_RATIO = 1.05


def _image(h: int, w: int, seed: int = 0) -> np.ndarray:
    """Smooth colour gradients with seeded noise: u8[h, w, 3]."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0.0, 1.0, h)[:, None, None]
    x = np.linspace(0.0, 1.0, w)[None, :, None]
    base = 0.5 + 0.4 * np.sin(6.0 * y + 9.0 * x + np.array([0.0, 1.0, 2.0]))
    return (np.clip(base + rng.normal(0.0, 0.08, (h, w, 3)), 0.0, 1.0) * 255.0).astype(np.uint8)


def _pillow_jpeg(img: np.ndarray, mode: str = "RGB", **kw) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, mode=mode).save(buf, format="JPEG", **kw)
    return buf.getvalue()


def _pillow_decode(data: bytes) -> np.ndarray:
    return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))


def assert_within_decoder_criterion(got: np.ndarray, want: np.ndarray) -> None:
    assert got.shape == want.shape and got.dtype == np.uint8, (got.shape, want.shape, got.dtype)
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max() <= MAX_LEVELS, diff.max()
    assert (diff == 0).mean() >= MIN_EQUAL, (diff == 0).mean()


DECODE_CASES = {
    "q75-444": ((61, 97), dict(quality=75, subsampling=0)),
    "q75-422": ((61, 97), dict(quality=75, subsampling=1)),
    "q75-420": ((61, 97), dict(quality=75, subsampling=2)),
    "q100-444": ((61, 97), dict(quality=100, subsampling=0)),
    "q100-422": ((61, 97), dict(quality=100, subsampling=1)),
    "q100-420": ((61, 97), dict(quality=100, subsampling=2)),
    "1x1-420": ((1, 1), dict(quality=90)),
    "1x1-444": ((1, 1), dict(quality=90, subsampling=0)),
    "2x3-420": ((3, 2), dict(quality=90)),
    "33x17-422": ((17, 33), dict(quality=90, subsampling=1)),
    "progressive-420": ((61, 97), dict(quality=90, progressive=True)),
    "progressive-444": ((61, 97), dict(quality=90, progressive=True, subsampling=0)),
    "restart-blocks": ((61, 97), dict(quality=90, restart_marker_blocks=3)),
    "restart-rows": ((61, 97), dict(quality=90, restart_marker_rows=1)),
    "progressive-restart": ((61, 97), dict(quality=90, progressive=True, restart_marker_blocks=5)),
    "optimized-huffman": ((61, 97), dict(quality=80, optimize=True)),
}


@pytest.mark.parametrize("case", sorted(DECODE_CASES))
def test_decoder_matches_pillow(case):
    (h, w), kw = DECODE_CASES[case]
    data = _pillow_jpeg(_image(h, w), **kw)
    if "restart" in case:
        assert b"\xff\xdd" in data, "Pillow wrote no restart interval"
    assert_within_decoder_criterion(imageio.read_jpeg(data), _pillow_decode(data))


def test_decoder_is_bit_equal_to_pillow_on_every_case():
    """Beyond the criterion: libjpeg's arithmetic, followed step by step,
    gives Pillow's texels exactly, grayscale included."""
    files = [_pillow_jpeg(_image(h, w), **kw) for (h, w), kw in DECODE_CASES.values()]
    files += [_pillow_jpeg(_image(*size)[..., 0], mode="L", quality=85) for size in ((61, 97), (1, 1))]
    for data in files:
        np.testing.assert_array_equal(imageio.read_jpeg(data), _pillow_decode(data))


@pytest.mark.parametrize("size", [(61, 97), (1, 1)])
def test_decoder_replicates_grayscale_to_rgb(size, tmp_path):
    gray = _image(*size)[..., 0]
    path = tmp_path / "gray.jpg"
    path.write_bytes(_pillow_jpeg(gray, mode="L", quality=85))
    got = imageio.read_jpeg(str(path))
    assert_within_decoder_criterion(got, _pillow_decode(path.read_bytes()))
    assert (got[..., 0] == got[..., 1]).all() and (got[..., 0] == got[..., 2]).all()


@pytest.mark.parametrize("size", [(61, 97), (16, 16), (1, 1), (17, 33), (360, 640)])
def test_encoder_matches_pillow_at_quality_100(size, tmp_path):
    img = _image(*size, seed=1)
    path = tmp_path / "port.jpg"
    imageio.write_jpeg(str(path), img)
    ours = path.read_bytes()
    theirs = _pillow_jpeg(img, quality=100)
    with Image.open(io.BytesIO(ours)) as im:  # what Pillow sees: baseline JFIF, 4:2:0, quality 100
        assert im.format == "JPEG" and im.size == (size[1], size[0]) and "progression" not in im.info
        assert "jfif" in im.info and im.layer == [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
        assert all(v == 1 for table in im.quantization.values() for v in table)
    dec_ours, dec_theirs = _pillow_decode(ours), _pillow_decode(theirs)
    assert_within_decoder_criterion(dec_ours, dec_theirs)
    mae_ours = np.abs(dec_ours.astype(np.int64) - img).mean()
    mae_theirs = np.abs(dec_theirs.astype(np.int64) - img).mean()
    assert mae_ours <= MAX_MAE_RATIO * mae_theirs + 1e-12, (mae_ours, mae_theirs)
    assert_within_decoder_criterion(imageio.read_jpeg(ours), dec_ours)
    # beyond the criterion: the entropy-coded data is Pillow's, byte for byte
    assert ours[ours.index(b"\xff\xda"):] == theirs[theirs.index(b"\xff\xda"):]


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_encoder_at_other_qualities(quality):
    img = _image(61, 97, seed=2)
    ours = imageio.jpeg_bytes(img, quality)
    dec_ours = _pillow_decode(ours)
    assert_within_decoder_criterion(dec_ours, _pillow_decode(_pillow_jpeg(img, quality=quality)))
    assert_within_decoder_criterion(imageio.read_jpeg(ours), dec_ours)


def _sof(marker: int, precision: int = 8, ncomp: int = 3) -> bytes:
    body = struct.pack(">BHHB", precision, 8, 8, ncomp) + b"".join(bytes([i + 1, 0x11, 0]) for i in range(ncomp))
    return b"\xff\xd8" + bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body + b"\xff\xd9"


@pytest.mark.parametrize("data, match", [
    (_sof(0xC3), "SOF3 \\(lossless\\)"),
    (_sof(0xC9), "SOF9 \\(arithmetic-coded sequential\\)"),
    (_sof(0xCA), "SOF10 \\(arithmetic-coded progressive\\)"),
    (_sof(0xC5), "SOF5 \\(differential sequential, hierarchical\\)"),
    (_sof(0xC1, precision=12), "12-bit precision \\(SOF1\\)"),
    (_sof(0xC0, ncomp=4), "4 components \\(CMYK/YCCK\\)"),
    (b"\x89PNG\r\n\x1a\n", "not a JPEG file"),
], ids=["SOF3", "SOF9", "SOF10", "SOF5", "12-bit-SOF1", "4-components", "not-a-jpeg"])
def test_decoder_refuses_what_it_does_not_take(data, match):
    with pytest.raises(ValueError, match=match):
        imageio.read_jpeg(data)


def test_decoder_refuses_pillow_cmyk():
    buf = io.BytesIO()
    Image.new("CMYK", (8, 8), (10, 20, 30, 40)).save(buf, format="JPEG")
    with pytest.raises(ValueError, match="4 components"):
        imageio.read_jpeg(buf.getvalue())


@pytest.mark.parametrize("size", [(61, 97), (1, 1)])
def test_png_round_trip_is_exact(size, tmp_path):
    img = _image(*size, seed=3)
    path = str(tmp_path / "x.png")
    imageio.write_png(path, img)
    np.testing.assert_array_equal(imageio.read_png(path), img)
    np.testing.assert_array_equal(np.asarray(Image.open(path).convert("RGB")), img)


@pytest.mark.parametrize("mode, ctype", [("RGBA", 6), ("L", 0), ("LA", 4)])
def test_png_reader_refuses_other_colour_types(mode, ctype, tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(_image(23, 41, seed=4)).convert(mode).save(path)
    with pytest.raises(ValueError, match=f"colour type {ctype}, .* is not supported"):
        imageio.read_png(path)


def _filtered_png(img: np.ndarray, ftype: int) -> bytes:
    """An RGB PNG whose rows after the first use row filter ``ftype`` (PNG spec, section 9)."""
    h, w, _ = img.shape
    raw = img.reshape(h, w * 3).astype(np.int64)
    out = []
    for y in range(h):
        f = ftype if y else 0
        prev = raw[y - 1] if y else np.zeros(w * 3, np.int64)
        left = np.r_[np.zeros(3, np.int64), raw[y, :-3]]
        upleft = np.r_[np.zeros(3, np.int64), prev[:-3]]
        p = left + prev - upleft
        pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
        paeth = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        pred = [0, left, prev, (left + prev) >> 1, paeth][f]
        out.append(bytes([f]) + ((raw[y] - pred) & 0xFF).astype(np.uint8).tobytes())

    def chunk(tag, data):
        return struct.pack(">I", len(data)) + tag + data + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(b"".join(out))) + chunk(b"IEND", b""))


@pytest.mark.parametrize("ftype, name", [(1, "Sub"), (2, "Up"), (3, "Average"), (4, "Paeth")])
def test_png_reader_refuses_filtered_rows(ftype, name):
    """A valid file (Pillow reads it) whose rows use a filter other than 0."""
    img = _image(11, 7, seed=6)
    data = _filtered_png(img, ftype)
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(data)).convert("RGB")), img)
    with pytest.raises(ValueError, match=f"row filter {ftype} \\({name}\\) is not supported"):
        imageio.read_png(data)


def test_other_extensions_raise(tmp_path):
    img = _image(4, 4)
    for fn in (lambda p: imageio.write_image(p, img), imageio.read_image):
        with pytest.raises(ValueError, match="'.bmp'"):
            fn(str(tmp_path / "x.bmp"))


def test_scenes_and_images_without_pillow(tmp_path, monkeypatch):
    """With Pillow made unimportable, a scene with an image texture still
    compiles from a JPEG file and ``save_image`` still writes a JPEG."""
    import torch

    from raytracer2022_tpu_torch.render.film import save_image
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder

    img = _image(32, 64, seed=5)
    tex_path = str(tmp_path / "tex.jpg")
    imageio.write_jpeg(tex_path, img)
    monkeypatch.setitem(sys.modules, "PIL", None)
    monkeypatch.setitem(sys.modules, "PIL.Image", None)
    with pytest.raises(ImportError):
        import PIL.Image  # noqa: F401
    b = SceneBuilder()
    b.sphere((0, 0, 0), 1, b.lambertian(b.image(tex_path)))
    scene = b.finalize(device="cpu")
    assert scene.stats.features == frozenset({"image"})
    np.testing.assert_array_equal(b.images[0], imageio.read_jpeg(tex_path)[::-1])
    out = str(tmp_path / "out.jpg")
    save_image(out, torch.as_tensor(img))
    monkeypatch.undo()
    assert _pillow_decode(open(out, "rb").read()).shape == img.shape
