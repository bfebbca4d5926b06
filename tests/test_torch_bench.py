"""The port's benchmark tool, ``tools/bench.py``, held against ``bench.py``
itself, and the smoke's card-vs-CPU statistic (``chip_smoke.pooled_check``,
``replicate_means``) on the CPU.

``bench.py`` runs in a subprocess with its heavy calls replaced by
recorders: importing it sets JAX's PRNG and compile cache for the whole
process.  Numbers of the tool here time the plain versions on this host;
the card's come from a run on the card."""

import json
import os
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from raytracer2022_tpu.render.camera import make_camera as jax_make_camera  # noqa: E402
from raytracer2022_tpu.render.integrator import TraceConfig as JaxTraceConfig  # noqa: E402
from raytracer2022_tpu.render.renderer import render_batch_regen as jax_render_batch_regen  # noqa: E402
from raytracer2022_tpu.scene import library as jlib  # noqa: E402
from raytracer2022_tpu_torch.render.camera import make_camera  # noqa: E402
from raytracer2022_tpu_torch.render.integrator import Schedule, choose_schedule  # noqa: E402
from raytracer2022_tpu_torch.render.renderer import RenderConfig  # noqa: E402
from raytracer2022_tpu_torch.scene import library as tlib  # noqa: E402
from raytracer2022_tpu_torch.tools import bench  # noqa: E402

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# bench.main() with its heavy calls recorded: the forward cells'
# arguments, the trip-count estimates, each timed cell's reps and its
# render's shape (the timed function runs once, through the recorders),
# the fit step's config and calls; then its last line
RECORD_JAX_BENCH = textwrap.dedent("""
    import json
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import bench
    from raytracer2022_tpu.scene.library import SCENES

    rec = {"forward": [], "estimates": [], "reps": [], "diff": [], "scan": [], "fit": None, "fit_calls": 0}

    def forward_mpaths(name, w, h, spp_par, spp_seq, key, pool=None):
        rec["forward"].append([name, w, h, spp_par, spp_seq, pool])
        return (1.0, 1.0, 1.0), SCENES["cornell_box"]()

    def median_time(fn, key, reps=5):
        rec["reps"].append(reps)
        fn(key)
        return 1.0, 1.0, 1.0

    def regen_iters_estimate(scene, cam, w, h, spp_par, spp_seq, cfg, split_drain=False):
        rec["estimates"].append([w, h, spp_par, spp_seq, cfg.max_depth, split_drain])
        return 7, cfg.max_depth

    def render_batch_regen_diff(s, cam, k, w, h, spp_par, spp_seq, n_iters, cfg, n_drain=0):
        rec["diff"].append([w, h, spp_par, spp_seq, cfg.max_depth])
        return jnp.zeros((3, h, w)), jnp.ones((h, w), jnp.int32)

    def render_batch(s, cam, k, w, h, spp, cfg):
        rec["scan"].append([w, h, spp, cfg.max_depth])
        return jnp.zeros((3, h, w))

    def fit_step_fn(cfg):
        rec["fit"] = [cfg.width, cfg.height, cfg.spp, cfg.max_depth]

        def step(scene, cam, target, key):
            rec["fit_calls"] += 1
            return scene, cam, jnp.zeros(())

        return step

    bench.forward_mpaths = forward_mpaths
    bench._median_time = median_time
    bench.regen_iters_estimate = regen_iters_estimate
    bench.render_batch_regen_diff = render_batch_regen_diff
    bench.render_batch = render_batch
    bench.fit_step_fn = fit_step_fn
    bench.SCENES = dict(SCENES, wwscene=SCENES["cornell_box"])
    bench.main()
    print(json.dumps(rec))
""")
JAX_POOL = {"pixel": "pixel", "global": True, None: None}  # the port's schedule -> bench.py's `pool`


@pytest.fixture(scope="module")
def jax_bench(tmp_path_factory):
    """(bench.py's last line, what its recorders saw)."""
    home = str(tmp_path_factory.mktemp("home"))  # bench.py's compile cache goes under ~
    out = subprocess.run([sys.executable, "-c", RECORD_JAX_BENCH], cwd=ROOT, capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, JAX_PLATFORMS="cpu", HOME=home))
    assert out.returncode == 0, out.stderr[-4000:]
    line, rec = out.stdout.strip().splitlines()[-2:]
    return json.loads(line), json.loads(rec)


def test_cells_reps_and_keys_are_bench_pys(jax_bench):
    line, rec = jax_bench
    assert list(line) == list(bench.KEYS)
    assert line["metric"] == bench.METRIC and line["value"] == bench.REF_CPU_PATHS_PER_S * line["vs_baseline"]
    assert rec["forward"] == [[c.scene, c.width, c.height, c.spp_par, c.spp_seq, JAX_POOL[c.schedule]]
                              for c in bench.FORWARD]
    assert all(c.reps == 5 and c.depth == 50 for c in bench.FORWARD)  # bench.py's _median_time default
    # book2 leaves the schedule to the heuristic, which picks the global pool as JAX's does at 32 samples
    book2 = bench.FORWARD[2]
    assert book2.schedule is None and choose_schedule(book2.spp_seq, book2.spp_par) is Schedule.GLOBAL
    diff = (bench.FWD_BWD, bench.FWD_BWD_OBJ)
    assert rec["estimates"] == [[c.width, c.height, c.spp_par, c.spp_seq, c.depth, True] for c in diff]
    assert rec["diff"] == [[c.width, c.height, c.spp_par, c.spp_seq, c.depth] for c in diff]
    scan = bench.FWD_BWD_SCAN
    assert rec["scan"] == [[scan.width, scan.height, scan.spp_par * scan.spp_seq, scan.depth]]
    assert rec["reps"] == [c.reps for c in (*diff, scan)]
    fit = bench.FIT_STEP
    assert rec["fit"] == [fit.width, fit.height, fit.spp_seq, fit.depth]
    assert rec["fit_calls"] == 1 + fit.reps  # a warm-up, then the timed steps
    assert line["fwd_bwd_regen_iters"] == 7  # the estimate's trip count, as it comes


def test_bench_on_the_cpu(capsys, tmp_path, monkeypatch):
    src = str(tmp_path / "assets")
    chip_smoke.write_stand_in_assets(src, shuttle=(20, 16))
    monkeypatch.setenv("RT2022_SOURCE_DIR", src)
    argv = ["--device", "cpu", "--size-div", "32", "--spp-div", "64", "--reps", "1"]
    assert bench.main(argv) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0].startswith("cpu: "), "the device line comes first"
    details = [json.loads(x) for x in lines[1:-1]]
    assert [d["cell"] for d in details] == [c.key for c in bench.CELLS]
    for d, c in zip(details, bench.CELLS):
        cut = bench.cut_cell(c, 32, 64, 1)
        assert (d["scene"], d["width"], d["height"], d["spp_par"], d["spp_seq"], d["depth"], d["reps"]) == (
            c.scene, cut.width, cut.height, c.spp_par, cut.spp_seq, c.depth, 1)
        assert d["device"] == "cpu" and d["k1_launches"] == 0  # the plain version on the CPU
        med, lo, hi = d["seconds"]
        assert 0 < lo <= med <= hi
        assert (d.get("assets") == src) == (c.scene == "wwscene")
        assert (d.get("iters", {}).get("pool", 0) > 0) == (c in bench.FORWARD)
    last = json.loads(lines[-1])
    chip_smoke.check_bench_line(last, [*bench.KEYS, "cut"])  # keys, finite positive numbers, spreads
    assert last["cut"] == "--size-div 32, --spp-div 64, --reps 1"


@pytest.mark.parametrize("durations, median", [([3.0, 1.0], 3.0), ([2.0, 5.0, 1.0], 2.0), ([4.0], 4.0)])
def test_the_median_is_times_len_over_2_of_the_sorted_times(monkeypatch, durations, median):
    """bench.py's rule: ``times[len // 2]``, so with 2 reps the larger time.
    Call ``i`` (seed ``i``) takes ``durations[i - 1]`` on a fake clock."""
    clock, seeds = [0.0], []

    def fn(seed):
        seeds.append(seed)
        clock[0] += durations[seed - 1] if seed else 100.0

    monkeypatch.setattr(bench.time, "perf_counter", lambda: clock[0])
    got = bench.median_time(fn, len(durations), torch.device("cpu"))
    assert got == (median, min(durations), max(durations), 0, None)
    assert seeds == list(range(len(durations) + 1))  # the warm-up's seed 0 is timed by no call


@pytest.mark.parametrize("case", ["identical streams", "an outlier replicate", "no replicates",
                                  "replicates off the cpu mean"])
def test_pooled_check(case):
    rng = np.random.default_rng(5)
    cpu = 0.3 + 0.01 * rng.standard_normal((chip_smoke.CPU_SEEDS, 3))
    n_cpu, n_card = 8, 128
    if case == "identical streams":
        # the replicates are the CPU renders, the card render their mean: z 0
        st = chip_smoke.pooled_check(cpu, cpu, cpu.mean(axis=0)[None], n_cpu, n_card)
        np.testing.assert_array_equal(st["z"], 0.0)
        np.testing.assert_array_equal(st["rep_z"], 0.0)
        # each set about its own mean: twice the sum of squares over 2 (C - 1) degrees of freedom
        np.testing.assert_allclose(st["sd"], cpu.std(axis=0, ddof=1), rtol=1e-12)
        np.testing.assert_allclose(st["var_ratio"], 1.0, rtol=1e-12)
        assert st["replicates"] == len(cpu)
    elif case == "an outlier replicate":
        reps = 0.3 + 0.01 * rng.standard_normal((32, 3))
        calm = chip_smoke.pooled_check(cpu, reps, cpu[:1], n_cpu, n_card)
        reps[7] += 0.5  # one rare bright path
        st = chip_smoke.pooled_check(cpu, reps, cpu[:1], n_cpu, n_card)
        assert (st["sd"] > st["cpu_sd"]).all() and (st["sd"] > calm["sd"]).all()
        assert (np.abs(st["z"]) < np.abs(calm["z"])).all() and (st["skew"] > 4).all()
        np.testing.assert_allclose(st["min_rel_bias"], chip_smoke.MAX_Z * st["se"] / cpu.mean(axis=0))
        # the outlier scatters the replicates past the cap: their variance counts MAX_VAR_RATIO times the CPU's
        var_cpu = cpu.var(axis=0, ddof=1)
        assert (st["var_ratio"] > chip_smoke.MAX_VAR_RATIO).all() and (calm["var_ratio"] < 3).all()
        c, k = len(cpu), len(reps)
        capped = np.sqrt(var_cpu * ((c - 1) + (k - 1) * chip_smoke.MAX_VAR_RATIO) / (c + k - 2))
        np.testing.assert_allclose(st["sd"], capped, rtol=1e-12)
    elif case == "no replicates":
        # K = 0: the check's statistic from the CPU renders alone
        card = cpu.mean(axis=0) + 0.004
        st = chip_smoke.pooled_check(cpu, np.zeros((0, 3)), card[None], n_cpu, n_card)
        sd = cpu.std(axis=0, ddof=1)
        want = (card - cpu.mean(axis=0)) / (sd * np.sqrt(1.0 / len(cpu) + n_cpu / n_card))
        np.testing.assert_allclose(st["z"][0], want, rtol=1e-12)
        np.testing.assert_allclose(st["sd"], sd, rtol=1e-12)
        assert st["replicates"] == 0 and np.isnan(st["skew"]).all()
        assert np.isnan(st["rep_z"]).all() and np.isnan(st["var_ratio"]).all()
    else:
        # the replicates' own mean is held to the CPU's: a shift of 6 standard errors reads 6, the card render 0
        reps = 0.3 + 0.01 * rng.standard_normal((32, 3))
        calm = chip_smoke.pooled_check(cpu, reps, cpu.mean(axis=0)[None], n_cpu, n_card)
        shift = 6.0 * calm["sd"] * np.sqrt(1.0 / len(cpu) + 1.0 / len(reps))
        st = chip_smoke.pooled_check(cpu, reps + shift - (reps.mean(axis=0) - cpu.mean(axis=0)),
                                     cpu.mean(axis=0)[None], n_cpu, n_card)
        np.testing.assert_allclose(st["sd"], calm["sd"], rtol=1e-12)  # a shift leaves the spread as it was
        np.testing.assert_allclose(st["rep_z"], 6.0, rtol=1e-9)
        np.testing.assert_array_equal(st["z"], 0.0)


def test_the_checks_bounds_are_unchanged():
    assert chip_smoke.MAX_Z == 5.0 and chip_smoke.MAX_REL == 0.08 and chip_smoke.CPU_SEEDS == 8
    assert chip_smoke.MAX_VAR_RATIO == 12.0
    assert chip_smoke.REPLICATES >= 32 and chip_smoke.WW_CHECK_REPLICATES >= 64


def _cornell(size, spp, **cam):
    bundle = tlib.cornell_box(device="cpu")
    cfg = RenderConfig(width=size, height=size, spp=spp, max_depth=50, background=bundle.background)
    return bundle.scene, make_camera(**dict(bundle.camera_kwargs, **cam), device="cpu"), cfg


def test_each_replicate_has_exactly_the_cpus_samples():
    """The camera looks out of the box's open side and the sky is 1: every
    sample adds exactly 1, so a replicate's mean is its samples per pixel
    over ``cfg.spp``."""
    scene, cam, _ = _cornell(8, 5, lookat=(278.0, 278.0, -1600.0))
    cfg = RenderConfig(width=8, height=6, spp=5, max_depth=50, background=(1.0, 1.0, 1.0))
    means = chip_smoke.replicate_means(scene, cam, cfg, 9)
    assert means.shape == (9, 3)
    np.testing.assert_array_equal(means, 1.0)


def test_replicates_match_seed_renders_and_the_jax_package():
    """K replicates from one quota launch against K renders of their own
    seeds (the same estimator: means within MAX_Z standard errors), and,
    by the check's own statistic, against one render of the JAX package at
    16 times the samples."""
    size, spp, k = 16, 8, 32
    scene, cam, cfg = _cornell(size, spp)
    reps = chip_smoke.replicate_means(scene, cam, cfg, k)
    seeds, n = chip_smoke._seed_means(scene, cam, cfg, range(200, 200 + k), spp)
    assert n == spp and reps.shape == seeds.shape == (k, 3)
    z = (reps.mean(axis=0) - seeds.mean(axis=0)) / np.sqrt((reps.var(axis=0, ddof=1) + seeds.var(axis=0, ddof=1)) / k)
    assert (np.abs(z) < chip_smoke.MAX_Z).all(), z

    jb = jlib.cornell_box()
    n_jax = 4 * 32
    img = jax_render_batch_regen(jb.scene, jax_make_camera(**jb.camera_kwargs), jax.random.PRNGKey(0), size, size,
                                 4, 32, JaxTraceConfig(max_depth=50, background=jb.background))
    m_jax = np.asarray(img, np.float64).mean(axis=(1, 2)) / n_jax
    st = chip_smoke.pooled_check(seeds[:chip_smoke.CPU_SEEDS], reps, m_jax[None], spp, n_jax)
    assert (np.abs(st["z"]) < chip_smoke.MAX_Z).all(), st["z"]
    assert (np.abs(m_jax - st["cpu_mean"]) / st["cpu_mean"] < chip_smoke.MAX_REL).all()
