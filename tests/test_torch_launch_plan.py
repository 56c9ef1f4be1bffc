"""K2's launch plan (``ops.cuda.sgm_kernel.launch_plan``) on the CPU.

The plan is what ``sgm_paths`` launches on the card for a call: one launch
per direction, except the whole form's two horizontals, which run as one
paired launch (``"hpair"``) where the first of them stands. It is a pure
function of the call's steps and form, so it is held here for every form
and a range of step subsets; the card tests hold the launches themselves.
"""

from collections import Counter

import pytest

from stereo_tpu_torch.ops.cuda.sgm_kernel import launch_plan
from stereo_tpu_torch.ops.sgm import H_STEPS, PATH_STEPS, V_STEPS

#: Step subsets, and the forms of their launches in the whole form.
SUBSETS = {
    "8_paths": (PATH_STEPS[:8], ["hpair"] + ["whole"] * 6),
    "4_paths": (PATH_STEPS[:4], ["hpair", "whole", "whole"]),
    "horizontals": (H_STEPS, ["hpair"]),
    "horizontals_reversed": (H_STEPS[::-1], ["hpair"]),
    "verticals": (V_STEPS, ["whole", "whole"]),
    "verticals_then_horizontals": (V_STEPS + H_STEPS,
                                   ["whole", "whole", "hpair"]),
    "horizontals_apart": (((1, 0), (0, -1), (1, 1), (0, 1)),
                          ["whole", "hpair", "whole"]),
    "one_horizontal": (((0, 1),), ["whole"]),
    "diagonals": (PATH_STEPS[4:8], ["whole"] * 4),
}

FORMS = ["whole", "rect", "shear+1", "shear-1", "mask"]


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_launch_plan(form, subset):
    steps, whole_forms = SUBSETS[subset]
    plan = launch_plan(steps, form)
    if form == "whole":
        assert [launch.form for launch in plan] == whole_forms
    else:  # the other forms launch once per direction, in order
        assert [launch.form for launch in plan] == [form] * len(steps)
        assert [launch.steps for launch in plan] == [(st,) for st in steps]
    # every direction runs exactly once; only the first launch writes S
    # without adding to it
    assert Counter(st for launch in plan for st in launch.steps) == Counter(
        steps)
    assert [launch.accumulate for launch in plan] == [
        i > 0 for i in range(len(plan))]
    paired = form == "whole" and "hpair" in whole_forms
    for launch in plan:
        if launch.form == "hpair":
            assert launch.steps == H_STEPS
        else:
            assert len(launch.steps) == 1
    # the single launches keep the call's order of directions
    singles = [launch.steps[0] for launch in plan if launch.form != "hpair"]
    assert singles == [st for st in steps if not (paired and st in H_STEPS)]
