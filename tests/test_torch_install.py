"""The installed port on the CPU: a wheel of the checkout carries the CUDA
and C++ sources, the stand-in writer and the ``rt2022-torch`` command;
installed with ``pip install --target`` and run from outside the checkout,
it renders ``wwscene`` to the checkout's bytes, builds its host runtime
under the per-user cache directory, and writes nothing under its install
directory.  The same helpers drive ``chip_smoke.py``'s phase ``installed``
on the card."""

import os
import subprocess
import zipfile

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu_torch import cli, cuda_build  # noqa: E402
from raytracer2022_tpu_torch.tools import standins  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGV = ["--device", "cpu", "--scene", "wwscene", "--width", "32", "--height", "18", "--spp", "2", "--quiet"]
SHUTTLE = (20, 16)  # 640 triangles: the CPU's plain version walks them by brute force
SHIPPED = ("raytracer2022_tpu_torch/csrc/bvh8.cu", "raytracer2022_tpu_torch/csrc/table_grad.cu",
           "raytracer2022_tpu_torch/csrc/mis_sample.cu", "raytracer2022_tpu_torch/csrc/mis_sample.cuh",
           "raytracer2022_tpu_torch/csrc/vertex.cu", "raytracer2022_tpu_torch/csrc/rt_native.cpp",
           "raytracer2022_tpu_torch/tools/standins.py")


@pytest.fixture(scope="module")
def installed(tmp_path_factory):
    """``(wheel, install directory)``: the checkout's wheel, installed."""
    tmp = tmp_path_factory.mktemp("install")
    wheel = chip_smoke.build_wheel(ROOT, str(tmp / "wheel"))
    target = str(tmp / "site")
    chip_smoke.install_wheel(wheel, target)
    return wheel, target


def _env(target, tmp_path, **extra):
    home = tmp_path / "home"
    home.mkdir(exist_ok=True)
    return chip_smoke.installed_env(target, str(home), OMP_NUM_THREADS="1", **extra)


def test_the_wheel_ships_the_sources_and_the_command(installed):
    wheel, target = installed
    with zipfile.ZipFile(wheel) as z:
        names = set(z.namelist())
        (entry,) = [n for n in names if n.endswith(".dist-info/entry_points.txt")]
        entry_points = z.read(entry).decode().splitlines()
        for name in SHIPPED:
            with open(os.path.join(ROOT, name), "rb") as f:
                assert z.read(name) == f.read(), name
    assert set(SHIPPED) <= names
    assert "rt2022-torch = raytracer2022_tpu_torch.cli:main" in entry_points
    assert os.path.isfile(os.path.join(target, "bin", "rt2022-torch"))


def test_the_installed_command_renders_the_checkouts_bytes_outside_the_checkout(installed, tmp_path, monkeypatch):
    _, target = installed
    work = tmp_path / "work"
    work.mkdir()
    source = str(work / "stand-ins")
    before = chip_smoke.tree_state(target)
    proc, rep = chip_smoke.run_installed(target, str(work), _env(target, tmp_path, RT2022_SOURCE_DIR=source),
                                         [*ARGV, "--out", "output.jpg"], SHUTTLE)
    assert proc.returncode == 0 and rep is not None, proc.stderr
    assert chip_smoke.tree_state(target) == before, "the installed run wrote under its install directory"
    assert rep["package"] == os.path.join(target, "raytracer2022_tpu_torch")
    assert rep["csrc"] == os.path.join(target, "raytracer2022_tpu_torch", "csrc")
    cache = str(tmp_path / "home" / ".cache" / "raytracer2022_tpu_torch")  # HOME's, XDG_CACHE_HOME unset
    assert rep["native"] is not None and rep["native"].startswith(os.path.join(cache, "native") + os.sep)
    assert rep["builds"] == [] and rep["k1_launches"] == 0  # the CPU walks the plain version
    assert not rep["chip_smoke_importable"]
    assert sorted(os.listdir(source)) == ["Jupiter.jpg", "Mars.jpg", "Saturn.jpg", "earthmap.jpg", "obj"]

    monkeypatch.setenv("RT2022_SOURCE_DIR", source)  # the checkout's CLI on the installed package's stand-ins
    out = tmp_path / "checkout.jpg"
    assert cli.main([*ARGV, "--out", str(out)]) == 0
    assert (work / "output.jpg").read_bytes() == out.read_bytes()


def test_the_commands_exit_code_is_mains(installed, tmp_path):
    """pip's console script ends in ``sys.exit(main())``: 0 for ``--help``,
    and the parser's 2 for an ``--out`` the CLI cannot write."""
    _, target = installed
    script = os.path.join(target, "bin", "rt2022-torch")
    with open(script) as f:
        assert "sys.exit(main())" in f.read()
    env = _env(target, tmp_path)
    ok = subprocess.run([script, "--help"], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=120)
    assert ok.returncode == 0 and "--device" in ok.stdout, ok.stderr
    bad = subprocess.run([script, "--out", "image.bmp"], cwd=tmp_path, env=env, capture_output=True, text=True,
                         timeout=120)
    assert bad.returncode == 2 and "--out" in bad.stderr, bad.stderr


@pytest.mark.parametrize("case", ["checkout", "installed, XDG_CACHE_HOME", "installed, HOME"])
def test_build_root(case, tmp_path, monkeypatch):
    """A checkout builds into ``build/`` at its root; an installed package
    (no repository ``pyproject.toml`` beside it) into the per-user cache."""
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path / "xdg"))
    if case == "checkout":
        assert cuda_build.build_root() == os.path.join(ROOT, "build")
        return
    site = tmp_path / "site"
    (site / "raytracer2022_tpu_torch").mkdir(parents=True)
    (site / "pyproject.toml").write_text('[project]\nname = "another-project"\n')
    monkeypatch.setattr(cuda_build, "_PKG_DIR", str(site / "raytracer2022_tpu_torch"))
    if case == "installed, HOME":
        monkeypatch.delenv("XDG_CACHE_HOME")
        assert cuda_build.build_root() == str(tmp_path / "home" / ".cache" / "raytracer2022_tpu_torch")
    else:
        assert cuda_build.build_root() == str(tmp_path / "xdg" / "raytracer2022_tpu_torch")


def test_standins_main_writes_the_files(tmp_path, capsys):
    assert standins.main([str(tmp_path)]) == 0
    assert "wrote earthmap.jpg" in capsys.readouterr().out
    with open(tmp_path / "obj" / "Shuttle.obj") as f:
        assert sum(line.startswith("f ") for line in f) == 96 * 68  # quads: 13,056 triangles
    for name in ("earthmap.jpg", *standins.PLANETS):
        assert (tmp_path / name).read_bytes()[:2] == b"\xff\xd8", name
