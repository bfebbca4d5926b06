"""Command-line renderer (PyTorch port).

Counterpart of ``raytracer2022_tpu/cli.py`` (the reference's main
program, raytracer/src/main.rs:28-231).  Renders on ``--device`` (default
``cuda``; a missing GPU is an error, never a silent move to the CPU).

With no arguments it renders the JAX CLI's default: ``wwscene`` at
640x360 x 100 spp, depth 50, into ``output/output.jpg``, reading the
scene's images and OBJ mesh from ``RT2022_SOURCE_DIR`` (a missing file is
an error that names it).  Example::

    python -m raytracer2022_tpu_torch.cli --scene cornell_box --width 600 \\
        --height 600 --spp 64 --out output/cornell.png

With ``--coordinator host:port --num-processes N --process-id K`` the
process is rank K of N (``parallel/distributed.py``) and renders its share
of the samples through ``parallel/mesh.py::render_sharded_regen_sum``;
rank 0 writes the image.  ``--sharded`` without a coordinator starts one
rank per visible card when ``--device cuda`` sees several, and renders on
the one device otherwise.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description="Path tracer, PyTorch/CUDA port")
    parser.add_argument("--scene", default="wwscene", help="scene name (scene.library.SCENES)")
    parser.add_argument("--width", type=int, default=640)
    parser.add_argument("--height", type=int, default=360)
    parser.add_argument("--spp", type=int, default=100)
    parser.add_argument("--max-depth", type=int, default=50)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--spp-per-batch", type=int, default=0)
    parser.add_argument("--out", default="output/output.jpg")
    parser.add_argument("--device", default="cuda", help="torch device (cuda, cuda:1, cpu)")
    parser.add_argument(
        "--sharded", action="store_true",
        help="shard spp over one rank per visible card (without --coordinator)",
    )
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--trace-dir", default=None, help="write a torch.profiler trace here")
    parser.add_argument(
        "--checkpoint", default=None,
        help="npz path: save the running radiance sum after every launch and resume "
        "an interrupted render with the same configuration",
    )
    # multi-process execution: one process per rank
    parser.add_argument("--coordinator", default=None, help="host:port of rank 0 (multi-process)")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    parser.add_argument(
        "--backend", default=None,
        help="torch.distributed backend, gloo or nccl (default: nccl on cards, gloo on the CPU)",
    )
    args = parser.parse_args(argv)

    import torch
    import torch.distributed as dist

    from raytracer2022_tpu_torch.parallel.distributed import init_distributed, is_primary, rank_device
    from raytracer2022_tpu_torch.parallel.mesh import make_device_mesh, render_sharded_regen_sum
    from raytracer2022_tpu_torch.parallel.worker import launch_local
    from raytracer2022_tpu_torch.render.camera import make_camera
    from raytracer2022_tpu_torch.render.film import save_image, tonemap_u8
    from raytracer2022_tpu_torch.render.renderer import RenderConfig, render_sum
    from raytracer2022_tpu_torch.scene.library import SCENES
    from raytracer2022_tpu_torch.utils.logging import StageLogger
    from raytracer2022_tpu_torch.utils.profiling import torch_trace

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        parser.error("--device cuda: no CUDA device is available (pass --device cpu to run on the CPU)")
    if args.scene not in SCENES:
        parser.error(f"unknown scene {args.scene!r}; choose from {sorted(SCENES)}")
    n_cards = torch.cuda.device_count() if device == torch.device("cuda") else 0
    if args.sharded and not args.coordinator and n_cards > 1:
        cmd = [sys.executable, "-m", "raytracer2022_tpu_torch.cli", *(sys.argv[1:] if argv is None else argv)]
        print(launch_local(n_cards, cmd, timeout_s=None)[0], end="")
        return 0

    mesh = None
    if args.coordinator:
        device = rank_device(args.device, args.process_id)
        init_distributed(args.coordinator, args.num_processes, args.process_id, backend=args.backend,
                         device=device)
        mesh = make_device_mesh(device.type)

    log = StageLogger(quiet=args.quiet)
    log.stage(1)
    log.config_echo(
        image_size=f"{args.width}x{args.height}",
        sample_per_pixel=args.spp,
        max_depth=args.max_depth,
        scene=args.scene,
        device=device,
    )
    bundle = SCENES[args.scene](seed=args.seed, device=device)
    cam_kwargs = dict(bundle.camera_kwargs)
    cam_kwargs["aspect_ratio"] = args.width / args.height
    camera = make_camera(**cam_kwargs, device=device)
    cfg = RenderConfig(
        width=args.width,
        height=args.height,
        spp=args.spp,
        max_depth=args.max_depth,
        background=bundle.background,
        seed=args.seed,
        spp_per_batch=args.spp_per_batch,
    )

    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"
    if mesh is not None:
        name += f", rank {mesh.get_local_rank()} of {mesh.size()}"
    log.stage(2, name)
    t0 = time.perf_counter()
    with torch_trace(args.trace_dir):
        if mesh is not None:
            total, n_samples = render_sharded_regen_sum(bundle.scene, camera, cfg, mesh)
        else:
            total = render_sum(
                bundle.scene, camera, cfg, progress=log.progress, checkpoint=args.checkpoint
            )
            n_samples = cfg.spp
        if device.type == "cuda":
            torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0

    log.stage(3, f"{args.width * args.height * n_samples / dt / 1e6:.2f} Mpaths/s on {name}")
    log.stage(4)
    img = tonemap_u8(total, n_samples)

    log.stage(5)
    if is_primary():  # one writer under multi-process
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        save_image(args.out, img)
        if not args.quiet:
            print(f'Output image as "{args.out}"')
    if mesh is not None:
        dist.destroy_process_group()
    log.done()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
