"""The control (the reference in bfloat16 in the program's place) is not
correct under the cells' limits, at a size a test run holds; and the
float32 reference in the program's place is."""

import pytest
import torch

import control
from harness import cell as cells
from harness.result import judge

SMALL = {"cornell_book3.frame": ((48, 48), {}), "wwscene.frame": ((64, 36), {"mesh": (20, 16), "maps": (64, 32)})}


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32], ids=["bf16", "f32"])
@pytest.mark.parametrize("name", list(SMALL))
def test_frame_control(name, dtype):
    c = cells.load(name)
    c.params["tile"] = 16
    (w, h), kw = SMALL[name]
    numbers = control.frame_control(c, 5, 2, torch.device("cpu"), dtype, frame=(w, h), describe_kw=kw, ref_spp=256)
    assert judge(numbers, c.limits)[0] == (dtype == torch.float32), numbers


def test_fit_control():
    c = cells.load("cornell_book3.fit")
    numbers = control.fit_control(c, 5, torch.device("cpu"), "bf16", fit={"width": 32, "height": 32, "spp": 16})
    assert not judge(numbers, c.limits)[0], numbers


def test_fit_gaps_hold_the_scenes_leaves_and_print_the_cameras():
    from harness.compare import fit_gaps

    def side(tex, origin):
        grads = {"mat_param": torch.zeros(4), "tex_color": torch.full((3, 5), tex), "origin": torch.full((3,), origin)}
        return {"losses": [1.0, 1.0, 1.0], "first_grad": grads, "change": {k: -0.15 * v for k, v in grads.items()}}

    ref = side(1.0, 0.01)
    c = cells.load("cornell_book3.fit")
    noisy = fit_gaps(side(1.0, 0.1), ref)
    assert noisy["_leaves"]["compared"] == ["tex_color"] and "origin" in noisy["_leaves"]["norms"]["first_grad"]
    assert judge({k: v for k, v in noisy.items() if k != "_leaves"}, c.limits)[0]
    scaled = fit_gaps(side(1.25, 0.01), ref)
    assert not judge({k: v for k, v in scaled.items() if k != "_leaves"}, c.limits)[0]
