"""The port's measurement tools on the CPU: ``tools/perf.py`` and
``tools/scaling.py`` (two gloo ranks), at tiny sizes, and the smoke's
wwscene study; every tool needs a card unless asked for the CPU, and none
imports JAX.  Their numbers here
time the plain versions on this host; the card's come from a run on the card."""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu_torch.parallel.worker import SCALING_PROBE, build_scene  # noqa: E402
from raytracer2022_tpu_torch.render.integrator import derive_seed, step_generator  # noqa: E402
from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_batch_regen  # noqa: E402
from raytracer2022_tpu_torch.tools import bench, flagship, golden, perf, scaling  # noqa: E402

torch.set_num_threads(1)

PERF_KEYS = {"scene", "prims", "scene_build_s", "first_call_s", "steady_s", "Mpaths_per_s"}
SCALING_KEYS = {"n_devices", "host_cores", "t_single_s", "t_sharded_s", "speedup_sharded_vs_single",
                "parallel_efficiency", "per_device_regen_iters", "iters_mean", "iters_max",
                "work_normalized_efficiency"}


def _json_lines(out: str) -> list:
    lines = out.strip().splitlines()
    assert lines[0].startswith("cpu: "), "the device line comes first"
    return [json.loads(line) for line in lines[1:]]


@pytest.mark.parametrize("scan", [False, True])
def test_perf_on_the_cpu(capsys, scan):
    argv = ["cornell_box", "random_scene", "--size", "16x16", "--spp", "4", "--depth", "4", "--device", "cpu"]
    assert perf.main(argv + (["--scan"] if scan else [])) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert [r["scene"] for r in recs] == ["cornell_box", "random_scene"]
    for r in recs:
        assert PERF_KEYS <= r.keys() and r["device"] == "cpu" and r["prims"] > 0
        for key in PERF_KEYS - {"scene", "prims"}:
            assert np.isfinite(r[key]) and r[key] > 0, (key, r[key])


def test_perf_renders_the_file_bound_scenes_from_the_asset_directory(capsys, tmp_path, monkeypatch):
    import chip_smoke

    src = str(tmp_path / "assets")
    chip_smoke.write_stand_in_assets(src, shuttle=(20, 16))
    monkeypatch.setenv("RT2022_SOURCE_DIR", src)
    argv = ["earth", "obj_uv_demo", "--size", "8x8", "--spp", "2", "--depth", "4", "--device", "cpu"]
    assert perf.main(argv) == 0
    recs = _json_lines(capsys.readouterr().out)
    assert [r["scene"] for r in recs] == ["earth", "obj_uv_demo"]
    assert all(r["assets"] == src and r["prims"] > 0 and r["Mpaths_per_s"] > 0 for r in recs)


def test_perf_writes_stand_ins_where_no_asset_directory_is_set(capsys, monkeypatch):
    monkeypatch.delenv("RT2022_SOURCE_DIR", raising=False)
    assert perf.main(["earth", "--size", "8x8", "--spp", "2", "--depth", "4", "--device", "cpu"]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert rec["assets"].endswith("stand-ins") and rec["prims"] > 0 and rec["Mpaths_per_s"] > 0
    assert not os.path.exists(rec["assets"]) and "RT2022_SOURCE_DIR" not in os.environ


def test_scaling_on_two_gloo_ranks(capsys):
    """Each rank's iteration count is the one a single process computes
    with that rank's generator; the work-normalised efficiency is at most 1."""
    size = 8
    assert scaling.main(["2", "--device", "cpu", "--size", str(size)]) == 0
    (rec,) = _json_lines(capsys.readouterr().out)
    assert SCALING_KEYS <= rec.keys()
    assert rec["n_devices"] == 2 and rec["backend"] == "gloo"
    assert rec["parallel_efficiency_divisor"] == min(2, rec["host_cores"])
    for key in ("t_single_s", "t_sharded_s", "speedup_sharded_vs_single", "parallel_efficiency"):
        assert np.isfinite(rec[key]) and rec[key] > 0, (key, rec[key])

    scene, cam, background = build_scene(scaling.SCENE, size, size, "cpu")
    lanes, samples, depth = SCALING_PROBE
    tcfg = RenderConfig(width=size, height=size, max_depth=depth, background=background).trace_cfg()
    want = []
    for rank in range(2):
        _, iters = render_batch_regen(scene, cam, step_generator(derive_seed(0, rank), 0, "cpu"), size, size,
                                      lanes, samples, tcfg, return_iters=True)
        want.append(sum(iters.values()))
    assert rec["per_device_regen_iters"] == want
    assert rec["iters_max"] == max(want) and rec["iters_mean"] == sum(want) / 2
    assert 0 < rec["work_normalized_efficiency"] <= 1


def _one_stream_on_both_sides(rec, label, spp, out):
    """The same seeds on both sides: renders are deterministic per seed, so
    the means are equal, the pooled z is 0, the sd ratio 1, and each of the
    two renders lies +-1/sqrt(3) from their mean by the CPU-only formula;
    the check's pooled sd rescales those z's by the CPU sd over itself."""
    assert rec["device_means"] == rec["cpu_means"] and rec["device_spp"] == rec["cpu_spp"] == spp
    np.testing.assert_array_equal(rec["pooled_z"], 0.0)
    np.testing.assert_allclose(rec["sd_ratio"], 1.0, rtol=1e-12)
    np.testing.assert_allclose(np.abs(rec["single_z"]), 3 ** -0.5, rtol=1e-9)
    assert rec["replicates"] == 2
    np.testing.assert_allclose(np.array(rec["pooled_sd_z"]) * rec["pooled_sd"],
                               np.array(rec["single_z_first"]) * rec["cpu_sd"], rtol=1e-9)
    assert rec["verdict"] == "draw" and rec["cpu_seeds"] == [100, 101]
    out = out.strip().splitlines()
    assert out[0].startswith("cpu: ") and json.loads(out[-1])[f"{label}_study"]["verdict"] == "draw"


@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")  # first_z: 0/0 when first == 2
def test_wwscene_study_of_one_stream_on_both_sides(capsys, monkeypatch):
    monkeypatch.setattr(chip_smoke, "WW_CHECK_REPLICATES", 2)
    rec = chip_smoke.wwscene_study((100, 101), (100, 101), first=2, factor=1, device="cpu")
    _one_stream_on_both_sides(rec, "wwscene", chip_smoke.WW_CHECK[2], capsys.readouterr().out)


@pytest.mark.filterwarnings("ignore:invalid value encountered:RuntimeWarning")  # first_z: 0/0 when first == 2
def test_card_cpu_study_of_one_stream_on_both_sides_two_perlin_spheres(capsys):
    """The study of phase library's two_perlin_spheres check (its build, at
    a quarter of its pixels) with the CPU on both sides."""
    build, cfg = chip_smoke.library_check("two_perlin_spheres")
    assert (cfg.width, cfg.height, cfg.spp) == (chip_smoke.SMALL, chip_smoke.SMALL, chip_smoke.SMALL_SPP)
    cfg = dataclasses.replace(cfg, width=cfg.width // 2, height=cfg.height // 2)
    rec = chip_smoke.card_cpu_study("two_perlin_spheres", build, cfg, (100, 101), (100, 101), 2, first=2, factor=1,
                                    device="cpu")
    assert rec["setup"] == f"two_perlin_spheres {cfg.width}x{cfg.height}, depth {chip_smoke.DEPTH}"
    _one_stream_on_both_sides(rec, "two_perlin_spheres", chip_smoke.SMALL_SPP, capsys.readouterr().out)


def test_tools_need_a_card_unless_asked_for_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device works")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        perf.main(["cornell_box"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        scaling.main(["2"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        flagship.main(["--spp", "1"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        golden.main(["--scene", "cornell_box_book"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])


def test_tools_import_neither_jax_nor_the_jax_package():
    """Nor the repository's scripts: the process runs from the repository's
    root, where ``chip_smoke`` is importable, and takes ``tools/perf.py``'s
    stand-in branch (no ``RT2022_SOURCE_DIR``), which writes the stand-ins
    with the package's own ``tools/standins.py``."""
    code = ("import sys; import raytracer2022_tpu_torch.tools.perf, raytracer2022_tpu_torch.tools.scaling, "
            "raytracer2022_tpu_torch.tools.flagship, raytracer2022_tpu_torch.tools.golden, "
            "raytracer2022_tpu_torch.tools.bench, raytracer2022_tpu_torch.tools.standins; "
            "assert raytracer2022_tpu_torch.tools.perf.main(['earth', '--size', '8x8', '--spp', '2', '--depth', '4', "
            "'--device', 'cpu']) == 0; "
            "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'raytracer2022_tpu', 'tools', 'chip_smoke')]; "
            "assert not bad, bad")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "RT2022_SOURCE_DIR"}
    out = subprocess.run([sys.executable, "-c", code], check=True, timeout=120, cwd=root, env=env,
                         capture_output=True, text=True).stdout
    assert '"scene": "earth"' in out and "stand-ins" in out, out
