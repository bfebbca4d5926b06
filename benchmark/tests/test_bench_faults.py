"""The comparison fails a broken timed path: the rest of a run is driven
on the CPU at a small size, with the program's output broken underneath,
and ``correct`` comes out false under the cells' own limits.  Frames: a
pass that leaves the image as it was, half the rows left out and the rest
scaled to the mean over them, one band's radiance altered where it is
produced.  The fit: a step that returns its state unchanged, a step that
renders half the rows (the mean over them), a step whose gradient and loss
are altered where they are produced.  (No cell runs across chips, so the
exchange between chips has no fault here.)"""

import time

import pytest
import torch

from harness import cell as cells
from harness.result import judge

SMALL = {"cornell_book3.frame": ((48, 48), {}), "wwscene.frame": ((64, 36), {"mesh": (20, 16), "maps": (64, 32)})}


def _unchanged(render):
    def fn(scene, cam, cfg, launch_log=None):
        total, n = render(scene, cam, cfg, launch_log=launch_log)
        return torch.zeros_like(total), n
    return fn


def _half(render):
    def fn(scene, cam, cfg, launch_log=None):
        total, n = render(scene, cam, cfg, launch_log=launch_log)
        h = total.shape[1]
        out = torch.zeros_like(total)
        out[:, : h // 2] = 2.0 * total[:, : h // 2]
        return out, n
    return fn


def _altered(render):
    def fn(scene, cam, cfg, launch_log=None):
        total, n = render(scene, cam, cfg, launch_log=launch_log)
        h = total.shape[1]
        out = total.clone()
        out[:, h // 3: h // 2] *= 1.5
        return out, n
    return fn


@pytest.mark.parametrize("fault", [_unchanged, _half, _altered], ids=["unchanged", "half", "altered"])
@pytest.mark.parametrize("name", list(SMALL))
def test_a_broken_frame_is_not_correct(name, fault):
    from raytracer2022_tpu_torch import render_sum_n

    frame = cells.load_module("modes", "frame")
    c = cells.load(name)
    c.params["tile"] = 16
    (w, h), kw = SMALL[name]
    rec = frame.measure(c, 77, 0.5, False, time.perf_counter(), torch.device("cpu"), frame=(w, h), describe_kw=kw,
                        render=fault(render_sum_n), ref_spp=256)
    correct, checks = judge(rec["numbers"], c.limits)
    assert not correct, checks


def _step_unchanged(rc, lr, iters):
    from raytracer2022_tpu_torch.parallel.mesh import fit_step_fn

    step = fit_step_fn(rc, lr=lr, regen_iters=iters)

    def fn(scene, cam, target, seed):
        return scene, cam, step(scene, cam, target, seed)[2]
    return fn


def _step_half(rc, lr, iters):
    import dataclasses

    from raytracer2022_tpu_torch.parallel.mesh import fit_step_fn

    half = dataclasses.replace(rc, height=rc.height // 2)
    step = fit_step_fn(half, lr=lr, regen_iters=iters)

    def fn(scene, cam, target, seed):  # the bottom rows' rays of a frame of half the height
        return step(scene, cam, target[:, : rc.height // 2], seed)
    return fn


def _step_altered(rc, lr, iters):
    from raytracer2022_tpu_torch.parallel.mesh import fit_step_fn

    step = fit_step_fn(rc, lr=1.25 * lr, regen_iters=iters)

    def fn(scene, cam, target, seed):
        s, c, loss = step(scene, cam, target, seed)
        return s, c, 1.25 * loss
    return fn


@pytest.mark.parametrize("fault", [_step_unchanged, _step_half, _step_altered], ids=["unchanged", "half", "altered"])
def test_a_broken_fit_step_is_not_correct(fault):
    fit = cells.load_module("modes", "fit")
    c = cells.load("cornell_book3.fit")
    rec = fit.measure(c, 77, 0.5, False, time.perf_counter(), torch.device("cpu"),
                      fit={"width": 32, "height": 32, "spp": 16}, step_fn=fault)
    correct, checks = judge(rec["numbers"], c.limits)
    assert not correct, checks
