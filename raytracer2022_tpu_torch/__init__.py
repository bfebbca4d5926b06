"""raytracer2022_tpu_torch: the path tracer ported to PyTorch and CUDA.

A second package beside the JAX reference ``raytracer2022_tpu``, with the
same layout and names (``scene/``, ``ops/``, ``render/``, ``utils/``,
``cli.py``, ``native.py``).  It imports ``torch`` and never ``jax``.
Plain tensor code is PyTorch; the JAX package's one Pallas kernel, the
8-ary BVH walk, is hand-written CUDA C++ for Hopper (``csrc/bvh8.cu``,
built with nvcc at first use).  Scenes and cameras build on the card
unless the caller passes ``device="cpu"``.  Renders are forward
(``render_sum_n``) or reverse-differentiable through ``torch.autograd``
(``render_batch``, ``render_batch_regen_diff``), and
``parallel.mesh.fit_step_fn`` and ``python -m raytracer2022_tpu_torch.fit``
fit materials, textures and the camera.  ``parallel/`` splits a render
and the fit step over several processes, one per rank, joined by
``torch.distributed`` (NCCL between cards, gloo on the CPU).
"""

from .render.camera import Camera, get_rays, make_camera
from .render.film import linear_image, save_image, tonemap_u8
from .render.integrator import Schedule, TraceConfig, trace, trace_regen, trace_regen_diff
from .render.renderer import (
    RenderConfig,
    regen_iters_estimate,
    render,
    render_batch,
    render_batch_regen,
    render_batch_regen_diff,
    render_sum,
    render_sum_n,
)
from .scene.builder import SceneBuilder
from .scene.types import SceneData

__all__ = [
    "Camera",
    "RenderConfig",
    "SceneBuilder",
    "SceneData",
    "Schedule",
    "TraceConfig",
    "get_rays",
    "linear_image",
    "make_camera",
    "regen_iters_estimate",
    "render",
    "render_batch",
    "render_batch_regen",
    "render_batch_regen_diff",
    "render_sum",
    "render_sum_n",
    "save_image",
    "tonemap_u8",
    "trace",
    "trace_regen",
    "trace_regen_diff",
]
