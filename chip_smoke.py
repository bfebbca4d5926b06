"""Smoke run of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Builds kernel K1 (``raytracer2022_tpu_torch/csrc/bvh8.cu``) with nvcc,
checks it against its plain PyTorch version on every primitive kind and on
the stand-in mesh at the main path's width, then renders through the
port's entry points: the stand-in mesh scene through ``render_sum_n``, and
``cornell_box`` through ``cli.main``.  Every phase that fails makes the
script exit non-zero; nothing falls back to the CPU.  The last line of
standard output is ``{"ok": true, "device": {...}}``; the line before the
card's name and power limit is the kernel table as JSON.
"""

from __future__ import annotations

import math

import numpy as np

# stand-in mesh: a torus standing in for the Shuttle mesh (13,079 triangles)
TORUS_CENTER = (278.0, 200.0, 300.0)
TORUS_RADII = (120.0, 50.0)  # major, minor
TORUS_TILT_DEG = 60.0  # about the x axis, so the camera sees into the ring
TORUS_ALBEDO = (0.8, 0.85, 0.88)


def stand_in_mesh_scene(builder, nu: int = 96, nv: int = 68) -> dict:
    """Add ``cornell_box``'s exact builder calls plus a closed torus of
    ``2 * nu * nv`` triangles (metal, fuzz 0) inside the box to
    ``builder``, an instance of either package's ``SceneBuilder``.  Returns
    the camera kwargs; the background is black.  With the defaults the
    mesh has 13,056 triangles."""
    b = builder
    light = b.rect_xz(213, 343, 127, 232, 554, b.diffuse_light((60.0, 60.0, 60.0)))
    b.flip_face(light)
    b.add_light(light)
    red = b.lambertian((0.65, 0.05, 0.05))
    white = b.lambertian((0.73, 0.73, 0.73))
    green = b.lambertian((0.12, 0.45, 0.15))
    b.rect_yz(0, 555, 0, 555, 555, red)
    b.rect_yz(0, 555, 0, 555, 0, green)
    b.rect_xz(0, 555, 0, 555, 0, white)
    b.rect_xz(0, 555, 0, 555, 555, white)
    b.rect_xy(0, 555, 0, 555, 555, white)

    big, small = TORUS_RADII
    phi = 2.0 * math.pi * np.arange(nu) / nu
    th = 2.0 * math.pi * np.arange(nv) / nv
    ring = big + small * np.cos(th)[None, :]
    x = ring * np.cos(phi)[:, None]
    y = np.broadcast_to(small * np.sin(th)[None, :], (nu, nv))
    z = ring * np.sin(phi)[:, None]
    a = math.radians(TORUS_TILT_DEG)
    verts = np.stack(
        [x, y * math.cos(a) - z * math.sin(a), y * math.sin(a) + z * math.cos(a)], axis=-1
    ) + np.asarray(TORUS_CENTER)
    metal = b.metal(TORUS_ALBEDO, 0.0)
    for i in range(nu):
        i1 = (i + 1) % nu
        for j in range(nv):
            j1 = (j + 1) % nv
            b.triangle(verts[i, j], verts[i1, j], verts[i1, j1], metal)
            b.triangle(verts[i, j], verts[i1, j1], verts[i, j1], metal)
    return dict(
        lookfrom=(278.0, 278.0, -800.0),
        lookat=(278.0, 278.0, 0.0),
        vup=(0.0, 1.0, 0.0),
        vfov=40.0,
        aspect_ratio=1.0,
        aperture=0.0,
        focus_dist=10.0,
        time0=0.0,
        time1=1.0,
    )


# ---------------------------------------------------------------------------
# K1 parity contract and inputs (shared with tests/test_torch_bvh8.py and
# tests/test_torch_kernels.py).  This part imports neither package, so kinds
# are the numbers both packages' scene/types.py define.
# ---------------------------------------------------------------------------

RTOL = 2e-5
ATOL = 2e-5
MIN_ID_MATCH = 0.99
SPHERE, MSPHERE, RECT, TRIANGLE, RING = 0, 1, 2, 3, 4


def check_parity(kind: int, ref, got) -> dict:
    """Hold ``got = (t, best, rows)`` against ``ref`` (numpy arrays, rows
    may be None): the same hit mask (best >= 0), t within rtol/atol 2e-5,
    at least 99% of winner ids equal (not for RING, whose overlapping bands
    tie exactly), and rows equal wherever the ids are equal.  Ids may
    differ only on exact-t ties across two leaves.  Returns the measured
    max |dt| and id agreement; raises AssertionError on a breach."""
    t_r, b_r, rows_r = ref
    t_g, b_g, rows_g = got
    hit_r = b_r >= 0
    hit_g = b_g >= 0
    n_diff = int((hit_r != hit_g).sum())
    assert n_diff == 0, f"kind {kind}: hit masks differ on {n_diff} rays"
    err = np.abs(t_g[hit_r].astype(np.float64) - t_r[hit_r])
    tol = ATOL + RTOL * np.abs(t_r[hit_r].astype(np.float64))
    assert (err <= tol).all(), f"kind {kind}: t differs, max |dt| {err.max()}"
    same = b_g[hit_r] == b_r[hit_r]
    id_match = float(same.mean()) if hit_r.any() else 1.0
    if kind != RING:
        assert id_match >= MIN_ID_MATCH, f"kind {kind}: only {id_match:.4f} of ids agree"
    if rows_r is not None and rows_g is not None:
        eq = hit_r.copy()
        eq[hit_r] = same
        assert np.array_equal(rows_g[:, eq], rows_r[:, eq]), f"kind {kind}: winner rows differ"
        assert not rows_g[:, ~hit_g].any(), f"kind {kind}: rows of missed rays are not zero"
    return {
        "max_abs_err": float(err.max()) if err.size else 0.0,
        "id_match": id_match,
        "hits": int(hit_r.sum()),
    }


def small_tree_scene(builder, kind: int, rng, n_prims: int = 100):
    """A generated scene of one primitive kind with an 8-ary tree (the
    shapes of the JAX package's tests/test_bvh8.py)."""
    b = builder
    mat = b.lambertian((0.5, 0.5, 0.5))
    for _ in range(n_prims):
        c = rng.uniform(-25, 25, 3)
        if kind == SPHERE:
            b.sphere(c, rng.uniform(0.5, 3.0), mat)
        elif kind == MSPHERE:
            b.moving_sphere(c, c + rng.uniform(-2, 2, 3), 0.0, 1.0, rng.uniform(0.5, 3.0), mat)
        elif kind == RECT:
            a0, b0 = c[0], c[1]
            b._rect(a0, a0 + rng.uniform(1, 8), b0, b0 + rng.uniform(1, 8),
                    c[2], int(rng.integers(0, 3)), mat)
        elif kind == TRIANGLE:
            b.triangle(c, c + rng.uniform(-4, 4, 3), c + rng.uniform(-4, 4, 3), mat)
        else:
            b.ring(rng.uniform(2, 25), rng.uniform(0.05, 0.5), mat)
    return b.finalize(bvh_threshold=16, cluster_size=32, bvh8_kinds=(kind,))


def random_rays(rng, n: int, lo: float, hi: float):
    """``n`` rays from origins uniform in [lo, hi)^3, Gaussian directions."""
    o = rng.uniform(lo, hi, (3, n)).astype(np.float32)
    d = rng.normal(size=(3, n)).astype(np.float32)
    tm = rng.uniform(0, 1, n).astype(np.float32)
    return o, d, tm


# ---------------------------------------------------------------------------
# the smoke run
# ---------------------------------------------------------------------------

T_MIN = 1e-3
WIDTH = HEIGHT = 600
SPP = 64
DEPTH = 50
LANES = 1 << 18  # the main path's launch width (RenderConfig.max_rays_per_batch)


def _read_png(path: str) -> np.ndarray:
    """Decode the filter-0, 8-bit RGB PNG that film.save_image writes."""
    import struct
    import zlib

    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n", "not a PNG"
    pos, idat, w, h = 8, b"", 0, 0
    while pos < len(data):
        (length,) = struct.unpack(">I", data[pos : pos + 4])
        tag = data[pos + 4 : pos + 8]
        body = data[pos + 8 : pos + 8 + length]
        if tag == b"IHDR":
            w, h = struct.unpack(">II", body[:8])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + length
    raw = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all(), "unexpected PNG row filter"
    return raw[:, 1:].reshape(h, w, 3)


def _time_cuda(fn, reps: int) -> float:
    """Mean milliseconds of ``fn()`` on the current stream, by CUDA events."""
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main(argv=None) -> int:
    import argparse
    import json
    import os
    import subprocess
    import sys
    import tempfile
    import time

    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--spp", type=int, default=SPP, help="samples per pixel of both renders")
    ap.add_argument("--profile", default=None,
                    help="profile one mesh launch; write its kernel table to this directory")
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs a CUDA card",
              file=sys.stderr)
        return 1
    # the port itself: without it (the script alone) this fails before any output
    from raytracer2022_tpu_torch import cli, native
    from raytracer2022_tpu_torch.cuda_build import build
    from raytracer2022_tpu_torch.ops.bvh8 import FAR, traverse_bvh8, traverse_bvh8_plain
    from raytracer2022_tpu_torch.ops.intersect import candidate_t
    from raytracer2022_tpu_torch.render.camera import get_rays, make_camera
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_sum_n
    from raytracer2022_tpu_torch.scene.builder import SceneBuilder
    from raytracer2022_tpu_torch.scene.types import Bvh8Tree

    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    name = torch.cuda.get_device_name(0)
    print(f"card: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    print(f"host BVH builder: {'native SAH (native/librt_native.so)' if native.available() else 'NumPy fallback'}",
          flush=True)

    # --- phase 2: build K1
    t0 = time.perf_counter()
    so_path, log, secs = build("bvh8.cu")
    print(f"K1 build: {time.perf_counter() - t0:.2f} s (nvcc {secs:.2f} s) -> {os.path.relpath(so_path)}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "stack frame" in line:
            print(f"  ptxas: {line.strip()}")

    def to_dev(*xs):
        return [torch.as_tensor(x, device=dev) for x in xs]

    def run_both(tree, kind, o, d, tm, t_init):
        got = traverse_bvh8(tree, kind, o, d, tm, T_MIN, t_init=t_init, return_rows=True)
        ti = torch.full_like(tm, FAR) if t_init is None else torch.clamp(t_init, max=FAR)
        ref = traverse_bvh8_plain(tree, kind, o, d, tm, T_MIN, ti)
        torch.cuda.synchronize()
        return [x.cpu().numpy() for x in ref], [x.cpu().numpy() for x in got]

    # --- phase 3a: all five kinds on small generated trees
    rng = np.random.default_rng(1234)
    for kind, kname in enumerate(["SPHERE", "MSPHERE", "RECT", "TRIANGLE", "RING"]):
        scene = small_tree_scene(SceneBuilder(), kind, rng)
        t8 = scene.bvh8[0]
        tree = Bvh8Tree(*(x.to(dev) for x in (t8.entries, t8.boxes, t8.prows, t8.axorder)))
        o, d, tm = to_dev(*random_rays(rng, 4096, -30, 30))
        for label, t_init in (("no t_init", None), ("+inf t_init", torch.full_like(tm, float("inf")))):
            ref, got = run_both(tree, kind, o, d, tm, t_init)
            rep = check_parity(kind, ref, got)
            print(f"K1 parity {kname:8s} {label:12s}: hits {rep['hits']}, max|dt| {rep['max_abs_err']:.3g}, "
                  f"ids equal {rep['id_match']:.4f}", flush=True)

    # --- phase 3b: the stand-in mesh tree at the main path's width
    b = SceneBuilder()
    cam_kw = stand_in_mesh_scene(b)
    mesh = b.finalize(device=dev)
    assert mesh.n_prims == 13062 and mesh.stats.trees[0][0] == TRIANGLE, "unexpected stand-in mesh"
    tree = mesh.bvh8[0]
    print(f"stand-in mesh: {mesh.n_prims} prims, tree of {tree.prows.shape[0]} leaf rows, "
          f"{tree.entries.shape[0] // 8} groups", flush=True)
    cam = make_camera(**cam_kw, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(7)
    side = 512  # 512 x 512 = 262,144 camera rays
    ys, xs = torch.meshgrid(torch.arange(side, device=dev), torch.arange(side, device=dev), indexing="ij")
    u = (xs.reshape(-1).float() + torch.rand(side * side, generator=gen, device=dev)) / (side - 1)
    v = (ys.reshape(-1).float() + torch.rand(side * side, generator=gen, device=dev)) / (side - 1)
    o_c, d_c, tm_c = get_rays(cam, u, v, gen)
    o_r, d_r, tm_r = to_dev(*random_rays(rng, 65536, 1.0, 554.0))
    o = torch.cat([o_c, o_r], 1)
    d = torch.cat([d_c, d_r], 1)
    tm = torch.cat([tm_c, tm_r])
    # finite t_init as the main path passes it: the dense windows' closest t
    t_dense = candidate_t(mesh, o, d, tm, T_MIN, float("inf"),
                          prim_slice=slice(mesh.stats.n_in_bvh, mesh.n_prims)).amin(dim=0)
    reports = {}
    for label, t_init in (("dense t_init", t_dense), ("+inf t_init", torch.full_like(tm, float("inf")))):
        ref, got = run_both(tree, TRIANGLE, o, d, tm, t_init)
        reports[label] = rep = check_parity(TRIANGLE, ref, got)
        print(f"K1 parity mesh {o.shape[1]} rays, {label}: hits {rep['hits']}, "
              f"max|dt| {rep['max_abs_err']:.3g}, ids equal {rep['id_match']:.5f}", flush=True)

    # time both at one launch's shape: 262,144 camera rays, dense t_init
    ti1 = t_dense[:LANES]
    k_ms = _time_cuda(
        lambda: traverse_bvh8(tree, TRIANGLE, o_c, d_c, tm_c, T_MIN, t_init=ti1, return_rows=True), 20
    )
    p_ms = _time_cuda(lambda: traverse_bvh8_plain(tree, TRIANGLE, o_c, d_c, tm_c, T_MIN, ti1), 2)
    print(f"K1 time at {LANES} rays: kernel {k_ms:.4f} ms, plain {p_ms:.3f} ms ({smi})", flush=True)

    # --- phase 4a: a small render, card against the CPU (plain traversal)
    small = RenderConfig(width=32, height=32, spp=64, max_depth=DEPTH, background=(0.0, 0.0, 0.0))
    means = []
    for device in ("cpu", dev):
        sb = SceneBuilder()
        stand_in_mesh_scene(sb, 24, 12)  # 576 triangles: the CPU walks it by brute force
        tot, cnt = render_sum_n(sb.finalize(device=device), make_camera(**cam_kw, device=device), small)
        means.append((tot / cnt).mean(dim=(1, 2)).cpu().numpy())
    m_cpu, m_gpu = means
    rel = np.abs(m_gpu - m_cpu) / np.maximum(m_cpu, 1e-6)
    print(f"32x32x64 small-mesh render, card vs CPU channel means: {m_gpu.round(4).tolist()} vs "
          f"{m_cpu.round(4).tolist()} (rel {rel.round(4).tolist()})", flush=True)
    assert (rel < 0.08).all(), "card and CPU renders disagree beyond Monte-Carlo noise"

    # --- phase 4b: the main path, the stand-in mesh through render_sum_n
    torch.cuda.synchronize()
    traverse_bvh8.launches = 0  # count only the main path's launches from here
    cfg = RenderConfig(width=WIDTH, height=HEIGHT, spp=args.spp, max_depth=DEPTH,
                       background=(0.0, 0.0, 0.0))
    launch_log: list = []
    t0 = time.perf_counter()
    total, n = render_sum_n(mesh, cam, cfg, launch_log=launch_log)
    torch.cuda.synchronize()
    dt_mesh = time.perf_counter() - t0
    mesh_launches = traverse_bvh8.launches
    img = (total / n).cpu().numpy()
    assert mesh_launches > 0, "the mesh render never launched K1"
    assert np.isfinite(img).all(), "mesh render has non-finite pixels"
    assert img.mean() > 1e-3, "mesh render is black"
    mpaths_mesh = WIDTH * HEIGHT * n / dt_mesh / 1e6
    print(f"mesh render {WIDTH}x{HEIGHT} x {n} spp, depth {DEPTH}: {dt_mesh:.2f} s, "
          f"{mpaths_mesh:.3f} Mpaths/s, K1 launches {mesh_launches}, "
          f"channel means {np.round(img.mean(axis=(1, 2)), 4).tolist()} ({smi})", flush=True)
    for i, rec in enumerate(launch_log):
        print(f"  launch {i}: {rec}")

    # --- phase 5: cornell_box through the CLI
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "cornell.png")
        t0 = time.perf_counter()
        rc = cli.main(["--scene", "cornell_box", "--width", str(WIDTH), "--height", str(HEIGHT),
                       "--spp", str(args.spp), "--out", out, "--quiet"])
        dt_cli = time.perf_counter() - t0
        assert rc == 0, f"cli returned {rc}"
        png = _read_png(out)
    launches = traverse_bvh8.launches
    assert launches == mesh_launches, "cornell_box has no tree, yet K1 was launched"
    assert png.shape == (HEIGHT, WIDTH, 3), png.shape
    assert png.mean() > 1.0, "cornell render is black"
    mpaths_cli = WIDTH * HEIGHT * args.spp / dt_cli / 1e6
    print(f"cli cornell_box {WIDTH}x{HEIGHT} x {args.spp} spp: {dt_cli:.2f} s wall (scene build and "
          f"PNG write included), {mpaths_cli:.3f} Mpaths/s, png {png.shape} mean {png.mean():.2f} ({smi})",
          flush=True)

    if args.profile:
        # launch 0 of the mesh render again (same seed, same lanes) under
        # torch.profiler: device time by kernel against its unprofiled wall
        from torch.profiler import ProfilerActivity, profile

        one = RenderConfig(width=WIDTH, height=LANES // WIDTH, spp=32, max_depth=DEPTH,
                           background=(0.0, 0.0, 0.0))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            render_sum_n(mesh, cam, one)
            torch.cuda.synchronize()
        table = prof.key_averages().table(sort_by="self_device_time_total", row_limit=25)
        # kernel rows only: an operator's row repeats its kernels' device time
        busy = sum(e.self_device_time_total for e in prof.key_averages()
                   if str(e.device_type).endswith("CUDA")) / 1e6
        wall = launch_log[0]["seconds"]
        os.makedirs(args.profile, exist_ok=True)
        with open(os.path.join(args.profile, "kernels.txt"), "w") as f:
            f.write(table)
        print(table)
        print(f"profile: launch 0 ({launch_log[0]['lanes']} lanes): device busy {busy:.3f} s of "
              f"{wall:.3f} s unprofiled wall ({100 * busy / wall:.1f}%)", flush=True)

    kernels = [{
        "name": "bvh8_traverse",
        "route": "cuda",
        "source": "raytracer2022_tpu_torch/csrc/bvh8.cu",
        "replaces": "raytracer2022_tpu/ops/bvh8.py:540",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in reports.values()),
        "ms": k_ms,
        "plain_ms": p_ms,
    }]
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                            "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
