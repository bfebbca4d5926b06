"""The port's golden-image tool against ``tools/golden.py``: the comparison
bit-equal on seeded images, the scene map, a render within Monte-Carlo
noise of the JAX tool's, and a run against a golden JPEG written by the
port's encoder, on the CPU."""

import json
import os

import numpy as np
import pytest
import torch

from raytracer2022_tpu_torch.tools import golden as tgolden
from raytracer2022_tpu_torch.utils.imageio import read_png, write_jpeg
from tools import golden as jgolden

torch.set_num_threads(1)

# the mean per-pixel gap between the port's render and JAX's, over the gap
# between two JAX seeds (tests/test_torch_scenes.py)
MAX_GAP_RATIO = 1.3
RENDER = ("cornell_box_book", 24, 24, 32)  # scene, width, height, spp


def _image(rng, h, w):
    return rng.uniform(0.0, 1.0, (h, w, 3))


@pytest.mark.parametrize("shape,grid", [((64, 64), (8, 8)), ((37, 53), (8, 11)), ((100, 30), (7, 3)),
                                        ((5, 9), (5, 9)), ((12, 20), (64, 114))])
def test_downsample_is_bit_equal_to_jax(shape, grid):
    img = _image(np.random.default_rng(sum(shape)), *shape)
    got, want = tgolden.downsample(img, *grid), jgolden.downsample(img, *grid)
    assert got.dtype == want.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)  # NaN where a cell holds no pixel, in both


@pytest.mark.parametrize("ours,theirs,grid", [((64, 64), (64, 64), 16), ((36, 64), (90, 160), 16),
                                              ((45, 61), (30, 30), 7), ((144, 256), (144, 256), 64),
                                              ((36, 64), (36, 64), 64)])
def test_compare_is_bit_equal_to_jax(ours, theirs, grid):
    rng = np.random.default_rng(ours[0] * 1000 + theirs[1])
    a, b = _image(rng, *ours), _image(rng, *theirs)
    got, want = tgolden.compare(a, b, grid=grid), jgolden.compare(a, b, grid=grid)
    assert list(got) == list(want) == ["mae", "rmse", "exposure", "mae_norm"]
    np.testing.assert_array_equal([got[k] for k in got], [want[k] for k in want])


def test_scene_map_is_jaxs():
    assert tgolden.GOLDEN_MAP == jgolden.GOLDEN_MAP
    assert tgolden.NO_GOLDEN == jgolden.NO_GOLDEN
    from raytracer2022_tpu_torch.scene.library import SCENES

    assert set(tgolden.GOLDEN_MAP) | set(tgolden.NO_GOLDEN) == set(SCENES)


def test_render_scene_matches_jax_within_noise():
    name, w, h, spp = RENDER
    got = tgolden.render_scene(name, w, h, spp, device="cpu")
    ref = [np.asarray(jgolden.render_scene(name, w, h, spp, seed=s)) for s in (0, 1)]
    assert got.shape == ref[0].shape == (h, w, 3) and got.dtype == np.float64
    assert 0.0 <= got.min() and got.max() <= 1.0 and got.mean() > 0.05
    gap = np.abs(got - ref[0]).mean()
    noise = np.abs(ref[1] - ref[0]).mean()
    assert gap < MAX_GAP_RATIO * noise, (gap, noise)


@pytest.fixture
def reference(tmp_path, monkeypatch):
    """A reference directory holding the port's own cornell_box_book render
    as its golden, a JPEG at quality 100, 48x48 (``output/book2/image18.jpg``),
    and two other goldens, one of another aspect."""
    root = tmp_path / "reference"
    os.makedirs(root / "output" / "book2")
    os.makedirs(root / "output" / "book1")
    os.makedirs(root / "output" / "book3")
    img = tgolden.render_scene("cornell_box_book", 48, 48, 8, device="cpu")
    u8 = (img * 255).astype(np.uint8)
    write_jpeg(str(root / "output" / "book2" / "image18.jpg"), u8)
    write_jpeg(str(root / "output" / "book1" / "grey.jpg"), np.full((40, 40, 3), 128, np.uint8))
    write_jpeg(str(root / "output" / "wide.jpg"), u8[:24])
    monkeypatch.setattr(tgolden, "REFERENCE", str(root))
    return root, img


def test_run_one_against_a_golden_jpeg(reference, tmp_path):
    root, img = reference
    save = str(tmp_path / "renders")
    m = tgolden.run_one("cornell_box_book", "output/book2/image18.jpg", 8, 48, 16, out_dir=save, device="cpu")
    assert {k: m[k] for k in ("scene", "golden", "width", "height", "spp")} == {
        "scene": "cornell_box_book", "golden": "output/book2/image18.jpg", "width": 48, "height": 48, "spp": 8}
    golden = tgolden.read_golden(str(root / "output" / "book2" / "image18.jpg"))
    assert m["mae"] < 0.01 and abs(m["exposure"] - 1.0) < 0.02  # the same render, through a q100 JPEG
    for key, value in tgolden.compare(img, golden, grid=16).items():
        assert m[key] == value, key
    np.testing.assert_array_equal(read_png(os.path.join(save, "cornell_box_book.png")), (img * 255).astype(np.uint8))


def test_find_ranks_the_goldens_of_the_renders_aspect(reference):
    rows = tgolden.find_best("cornell_box_book", 8, 48, 16, 1.0, device="cpu")
    assert [rel for _, rel, _ in rows] == ["output/book2/image18.jpg", "output/book1/grey.jpg"]
    assert rows[0][0] < 0.01 < rows[1][0]


def test_main_prints_one_record_a_scene(reference, capsys):
    argv = ["--scene", "cornell_box_book", "--spp", "8", "--size", "48", "--grid", "16", "--device", "cpu"]
    assert tgolden.main(argv) == 0
    captured = capsys.readouterr()
    (rec,) = [json.loads(line) for line in captured.out.strip().splitlines()]
    assert rec["golden"] == "output/book2/image18.jpg" and rec["mae"] < 0.01
    assert "# worst MAE" in captured.err
