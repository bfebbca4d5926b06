"""The port's flagship tool on the CPU: ``wwscene`` from the 640-triangle
stand-in assets at 64x36, beside the JAX tool (``tools/flagship.py``) run
on the same files in a subprocess.  Its chunks, workload, path count and
record keys are the JAX tool's and its total lies within Monte-Carlo noise
of JAX's; its total is the sum of ``render_sum_n``'s chunks with seeds
``1000 + ci``, each rescaled by ``spp_c / n``; an interrupted run equals an
uninterrupted one bit for bit; a rerun after a finished partial last chunk
renders nothing where the JAX tool's renders it again; a resume that would
render samples twice is refused; its comparison is ``tools/golden.py``'s."""

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu_torch.render.camera import make_camera  # noqa: E402
from raytracer2022_tpu_torch.render.film import tonemap_u8  # noqa: E402
from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_sum_n  # noqa: E402
from raytracer2022_tpu_torch.scene.library import SCENES  # noqa: E402
from raytracer2022_tpu_torch.tools import flagship  # noqa: E402
from raytracer2022_tpu_torch.tools.golden import compare  # noqa: E402
from raytracer2022_tpu_torch.utils.imageio import read_image, read_png, write_jpeg  # noqa: E402

torch.set_num_threads(1)

W, H = 64, 36
# chunk 0 renders 17 spp, which render_sum_n rounds up to 18 (2 lanes x 9
# samples at 64x36), so its sum is rescaled by 17/18; chunk 1 is a partial
# last chunk of 1 spp
SPP, CHUNK = 18, 17
COMPARE_KEYS = ("mae", "rmse", "exposure", "mae_norm")
# the mean per-pixel gap between the port's total and the JAX tool's, over
# the gap between two JAX estimates (tests/test_torch_scenes.py)
MAX_GAP_RATIO = 1.3
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# The JAX tool on the CPU: a run, a rerun on its finished state, and a
# second JAX estimate of the image (the tool's loop with seeds 2000 + ci).
# Argv: state, out, spp, chunk, width, height.
JAX_TOOL = """
import shutil, sys
import jax
jax.config.update("jax_platforms", "cpu")
import numpy as np
from raytracer2022_tpu import RenderConfig, make_camera
from raytracer2022_tpu.render.renderer import render_sum_n
from raytracer2022_tpu.scene.library import SCENES
from tools import flagship
state, out = sys.argv[1:3]
spp, chunk, w, h = map(int, sys.argv[3:7])
argv = ["--spp", str(spp), "--chunk", str(chunk), "--width", str(w), "--height", str(h),
        "--state", state, "--out", out, "--golden", ""]
assert flagship.main(argv) == 0
shutil.copy(state, state + ".first.npz")
print("# rerun", flush=True)
assert flagship.main(argv) == 0
bundle = SCENES["wwscene"]()
cam = make_camera(**bundle.camera_kwargs)
other = np.zeros((3, h, w))
for ci, lo in enumerate(range(0, spp, chunk)):
    spp_c = min(chunk, spp - lo)
    cfg = RenderConfig(width=w, height=h, spp=spp_c, max_depth=50, background=bundle.background, seed=2000 + ci)
    part, n = render_sum_n(bundle.scene, cam, cfg)
    other += np.asarray(part, np.float64) * (spp_c / n)
np.save(state + ".other.npy", other)
"""


@pytest.fixture(scope="module")
def source_dir(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("assets"))
    chip_smoke.write_stand_in_assets(path, shuttle=(20, 16))
    return path


def run(source_dir, state, out, spp=SPP, chunk=CHUNK, golden="", size=(W, H)):
    """flagship.main on the CPU -> (its JSON record, its '#' lines)."""
    argv = ["--spp", str(spp), "--chunk", str(chunk), "--width", str(size[0]), "--height", str(size[1]),
            "--state", str(state), "--out", str(out), "--golden", str(golden), "--device", "cpu"]
    buf = io.StringIO()
    with chip_smoke.source_dir_env(source_dir), contextlib.redirect_stdout(buf):
        assert flagship.main(argv) == 0
    lines = buf.getvalue().strip().splitlines()
    assert lines[0].startswith("cpu: "), "the device line comes first"
    return json.loads(lines[-1]), [line for line in lines if line.startswith("#")]


def chunk_lines(lines):
    return [line.split(":")[0] for line in lines if line.startswith("# chunk ")]


def chunk_spp(lines):
    """The '# chunk' lines without their time and rate."""
    return [re.sub(r" in \S+s \(\S+ Mpaths/s\)", "", line) for line in lines if line.startswith("# chunk ")]


def load_state(path):
    with np.load(path) as st:
        return st["total"], int(st["done_spp"]), float(st["elapsed"])


@pytest.fixture(scope="module")
def whole(source_dir, tmp_path_factory):
    """One uninterrupted run: its record, lines, state file and image file."""
    tmp = tmp_path_factory.mktemp("whole")
    state, out = tmp / "state.npz", tmp / "out.png"
    rec, lines = run(source_dir, state, out)
    return {"rec": rec, "lines": lines, "state": state, "out": out}


@pytest.fixture(scope="module")
def jax_tool(source_dir, tmp_path_factory):
    """The JAX tool's run and rerun at the port's flags: their records,
    '#' lines and states, and a second JAX estimate of the total."""
    tmp = tmp_path_factory.mktemp("jax")
    state = str(tmp / "state.npz")
    env = dict(os.environ, JAX_PLATFORMS="cpu", RT2022_SOURCE_DIR=source_dir, HOME=str(tmp),
               PYTHONPATH=os.pathsep.join([ROOT, os.environ.get("PYTHONPATH", "")]))
    argv = [state, str(tmp / "out.png"), str(SPP), str(CHUNK), str(W), str(H)]
    proc = subprocess.run([sys.executable, "-c", JAX_TOOL, *argv], cwd=ROOT, env=env, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-4000:]
    first, rerun = proc.stdout.split("# rerun\n")
    runs = {}
    for tag, text, path in (("first", first, state + ".first.npz"), ("rerun", rerun, state)):
        lines = text.strip().splitlines()
        runs[tag] = {"rec": json.loads(lines[-1]), "lines": [line for line in lines if line.startswith("#")],
                     "state": load_state(path)}
    runs["other"] = np.load(state + ".other.npy")
    return runs


def test_chunks_and_record_are_the_jax_tools(whole, jax_tool):
    jax_rec, port_rec = jax_tool["first"]["rec"], whole["rec"]
    assert chunk_spp(whole["lines"]) == chunk_spp(jax_tool["first"]["lines"]) == [
        f"# chunk 1/2: {CHUNK} spp, total {CHUNK}/{SPP}", f"# chunk 2/2: {SPP - CHUNK} spp, total {SPP}/{SPP}"]
    assert list(port_rec)[:len(jax_rec)] == list(jax_rec) == ["workload", "wall_s", "paths", "Mpaths_per_s"]
    assert port_rec["workload"] == jax_rec["workload"] and port_rec["paths"] == jax_rec["paths"]
    assert load_state(whole["state"])[1] == jax_tool["first"]["state"][1] == SPP


def test_total_matches_the_jax_tools_within_noise(whole, jax_tool):
    got = load_state(whole["state"])[0] / SPP
    ref = jax_tool["first"]["state"][0] / SPP
    other = jax_tool["other"] / SPP
    assert got.shape == ref.shape == (3, H, W) and np.isfinite(got).all()
    gap = np.abs(got - ref).mean()
    noise = np.abs(other - ref).mean()
    assert 0 < gap < MAX_GAP_RATIO * noise, (gap, noise)


def test_total_is_the_sum_of_the_rescaled_chunks(whole, source_dir):
    bundle = SCENES["wwscene"](source_dir=source_dir, device="cpu")
    cam = make_camera(**bundle.camera_kwargs, device="cpu")
    want = np.zeros((3, H, W))
    for ci, spp_c in enumerate((CHUNK, SPP - CHUNK)):
        cfg = RenderConfig(width=W, height=H, spp=spp_c, max_depth=50, background=bundle.background, seed=1000 + ci)
        part, n = render_sum_n(bundle.scene, cam, cfg)
        assert n == (18 if ci == 0 else 1)
        want = want + part.numpy().astype(np.float64) * (spp_c / n)
    total, done, elapsed = load_state(whole["state"])
    assert done == SPP and elapsed == whole["rec"]["wall_s"] > 0
    np.testing.assert_array_equal(total, want)
    img = tonemap_u8(torch.from_numpy(want.astype(np.float32)), SPP).numpy()
    np.testing.assert_array_equal(read_png(str(whole["out"])), img)
    assert img.std() > 1.0, "the image is blank"
    assert chunk_lines(whole["lines"]) == ["# chunk 1/2", "# chunk 2/2"]
    assert whole["lines"][0].endswith(f"total {CHUNK}/{SPP}") and whole["lines"][1].endswith(f"total {SPP}/{SPP}")


def test_an_interrupted_run_equals_an_uninterrupted_one(whole, source_dir, tmp_path):
    state, out = tmp_path / "state.npz", tmp_path / "out.png"
    _, first = run(source_dir, state, tmp_path / "first.png", spp=CHUNK)
    assert chunk_lines(first) == ["# chunk 1/1"]
    _, second = run(source_dir, state, out)
    assert second[0].startswith(f"# resuming: {CHUNK}/{SPP} spp")
    assert chunk_lines(second) == ["# chunk 2/2"], "the resumed run rendered a finished chunk"
    total, done, _ = load_state(state)
    want, want_done, _ = load_state(whole["state"])
    assert done == want_done == SPP
    np.testing.assert_array_equal(total, want)
    assert out.read_bytes() == whole["out"].read_bytes()


def test_a_rerun_after_a_finished_partial_last_chunk_renders_nothing(whole, jax_tool, source_dir, tmp_path):
    """The deliberate divergence from ``tools/flagship.py:71``: JAX skips a
    chunk when ``lo + chunk <= done_spp``, so a rerun renders the finished
    partial last chunk again and adds it to the total while ``done_spp``
    stays, and the image comes out too bright.  The port skips it when
    ``lo + spp_c <= done_spp``."""
    jax_first, jax_rerun = jax_tool["first"]["state"], jax_tool["rerun"]["state"]
    assert chunk_lines(jax_tool["rerun"]["lines"]) == ["# chunk 2/2"], "the JAX tool's rerun renders the last chunk"
    assert jax_rerun[1] == jax_first[1] == SPP and jax_rerun[0].sum() > jax_first[0].sum()
    state, out = tmp_path / "state.npz", tmp_path / "out.png"
    shutil.copy(whole["state"], state)
    rec, lines = run(source_dir, state, out)
    assert chunk_lines(lines) == [] and lines == [f"# resuming: {SPP}/{SPP} spp, {whole['rec']['wall_s']:.0f}s so far"]
    total, done, elapsed = load_state(state)
    want, _, want_elapsed = load_state(whole["state"])
    np.testing.assert_array_equal(total, want)
    assert done == SPP and elapsed == want_elapsed
    assert out.read_bytes() == whole["out"].read_bytes()
    assert rec["k1_launches"] == 0 and rec["wall_s"] == whole["rec"]["wall_s"]


def test_the_record_holds_the_run(whole, source_dir):
    rec = whole["rec"]
    assert rec["workload"] == f"wwscene {W}x{H} x {SPP} spp x depth 50"
    assert rec["paths"] == W * H * SPP and rec["Mpaths_per_s"] == W * H * SPP / rec["wall_s"] / 1e6
    # beside them: the device, K1's launches (none on the CPU: the plain version ran) and the assets
    assert rec["device"] == "cpu" and rec["k1_launches"] == 0 and rec["assets"] == source_dir
    assert not set(COMPARE_KEYS) & set(rec) and "note" not in rec  # --golden ''


@pytest.mark.parametrize("golden_size", [(128, 72), (96, 72)])
def test_the_golden_comparison_is_golden_pys(source_dir, tmp_path, golden_size):
    """A finished state of 128x72 renders nothing; its image is compared
    with a quality-100 JPEG of itself, or of its left part (another shape,
    noted in the record)."""
    size, spp = (128, 72), 4
    yy, xx = np.mgrid[0:size[1], 0:size[0]]
    total = np.stack([(0.5 + 0.4 * np.sin(xx / 17.0 + c) * np.cos(yy / 11.0)) ** 2 for c in range(3)]) * spp
    state = tmp_path / "state.npz"
    np.savez(state, total=total, done_spp=spp, elapsed=2.0, chunk=2, width=size[0], height=size[1])
    img = tonemap_u8(torch.from_numpy(total.astype(np.float32)), spp).numpy()
    golden = tmp_path / "golden.jpg"
    write_jpeg(str(golden), img[:, :golden_size[0]])
    rec, lines = run(source_dir, state, tmp_path / "out.png", spp=spp, chunk=2, golden=golden, size=size)
    assert chunk_lines(lines) == [] and rec["wall_s"] == 2.0
    np.testing.assert_array_equal(read_png(str(tmp_path / "out.png")), img)
    want = compare(img.astype(np.float32) / 255.0, read_image(str(golden)).astype(np.float32) / 255.0)
    assert list(want) == list(COMPARE_KEYS)
    np.testing.assert_array_equal([rec[k] for k in COMPARE_KEYS], [want[k] for k in COMPARE_KEYS])  # NaN in both
    if golden_size == size:
        assert rec["mae"] < 0.01 and "note" not in rec
    else:
        assert rec["note"] == f"golden shape (72, {golden_size[0]}, 3) != ours (72, 128, 3)"
    # a --golden that does not exist is skipped, as in the JAX tool
    rec, _ = run(source_dir, state, tmp_path / "out.png", spp=spp, chunk=2, golden=tmp_path / "none.jpg", size=size)
    assert not set(COMPARE_KEYS) & set(rec)


def test_a_missing_asset_raises_and_nothing_is_written(tmp_path):
    empty = tmp_path / "empty"
    os.makedirs(empty)
    with pytest.raises(FileNotFoundError, match="Saturn.jpg.*RT2022_SOURCE_DIR"):
        run(str(empty), tmp_path / "state.npz", tmp_path / "out.png")
    assert os.listdir(empty) == [] and sorted(os.listdir(tmp_path)) == ["empty"]


def test_a_larger_spp_after_a_partial_last_chunk_is_refused(source_dir, tmp_path):
    """--spp 3 --chunk 2 ends on a partial chunk of 1 spp; --spp 4 would
    render that chunk's seed again at 2 spp on top of it."""
    state, out = tmp_path / "state.npz", tmp_path / "out.png"
    run(source_dir, state, tmp_path / "first.png", spp=3, chunk=2, size=(16, 9))
    held = state.read_bytes()
    with pytest.raises(ValueError, match="holds 3 spp, which ends no chunk of --spp 4 --chunk 2"):
        run(source_dir, state, out, spp=4, chunk=2, size=(16, 9))
    assert state.read_bytes() == held and not out.exists()


@pytest.mark.parametrize("kept,match", [
    ({"chunk": 3, "width": W, "height": H}, "holds a run of"),  # another --chunk
    ({"chunk": 2, "width": 32, "height": H}, "holds a run of"),  # another frame
    ({}, "holds a run of"),  # no flags kept, as the JAX tool's state
    ({"chunk": 2, "width": W, "height": H, "done_spp": 6}, "holds 6 spp, which ends no chunk"),  # more than --spp
])
def test_a_state_of_another_run_is_refused(source_dir, tmp_path, kept, match):
    state, out = tmp_path / "state.npz", tmp_path / "out.png"
    np.savez(state, **{"total": np.zeros((3, H, W)), "done_spp": 2, "elapsed": 1.0, **kept})
    held = state.read_bytes()
    with pytest.raises(ValueError, match=match):
        run(source_dir, state, out, spp=4, chunk=2)
    assert state.read_bytes() == held and not out.exists()


def _scene_reached(**kwargs):
    raise RuntimeError("the scene was built")


@pytest.mark.parametrize("state_held", [True, False])
@pytest.mark.parametrize("flag, name", [("--out", "x.tif"), ("--out", "x.bmp"), ("--golden", "golden.bmp")])
def test_an_unwritable_out_or_unreadable_golden_is_refused_first(tmp_path, monkeypatch, capsys, state_held, flag,
                                                                 name):
    """Refused when the flags are parsed: before the state is read (this
    one, of another run, would raise ValueError if it were) and before any
    chunk renders, so a held state stays byte-equal and none is made."""
    from raytracer2022_tpu_torch.scene import library

    monkeypatch.setitem(library.SCENES, "wwscene", _scene_reached)
    state = tmp_path / "state.npz"
    if state_held:
        np.savez(state, total=np.zeros((3, H, W)), done_spp=2, elapsed=1.0)
        held = state.read_bytes()
    paths = {"--out": str(tmp_path / "out.png"), "--golden": ""}
    paths[flag] = str(tmp_path / name)
    if flag == "--golden":
        (tmp_path / name).write_bytes(b"BM")
    with pytest.raises(SystemExit) as e:
        flagship.main(["--spp", "2", "--chunk", "1", "--width", str(W), "--height", str(H), "--state", str(state),
                       "--out", paths["--out"], "--golden", paths["--golden"], "--device", "cpu"])
    err = capsys.readouterr().err
    assert e.value.code == 2 and name in err and "(use .jpg, .jpeg, .png)" in err, err
    assert state.read_bytes() == held if state_held else not state.exists()
    assert not (tmp_path / "out.png").exists()


@pytest.mark.parametrize("out, golden", [("x.jpg", ""), ("x.jpeg", ""), ("x.png", "golden.JPG"),
                                         ("x.JPG", "golden.png"), ("x.png", "absent.bmp")])
def test_a_writable_out_and_readable_golden_pass_the_check(tmp_path, monkeypatch, out, golden):
    """.jpg, .jpeg and .png in any case pass, and a --golden that does not
    exist is not checked (the tool skips it)."""
    from raytracer2022_tpu_torch.scene import library

    monkeypatch.setitem(library.SCENES, "wwscene", _scene_reached)
    if golden and golden != "absent.bmp":
        (tmp_path / golden).write_bytes(b"")
    with pytest.raises(RuntimeError, match="the scene was built"):
        flagship.main(["--spp", "2", "--chunk", "1", "--width", str(W), "--height", str(H), "--state",
                       str(tmp_path / "state.npz"), "--out", str(tmp_path / out),
                       "--golden", str(tmp_path / golden) if golden else "", "--device", "cpu"])
    assert not (tmp_path / "state.npz").exists()
