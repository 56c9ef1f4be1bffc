"""K2's launch plan (``ops.cuda.sgm_kernel.launch_plan``) on the CPU.

The plan is what ``sgm_paths`` launches on the card for a call: one launch
per direction, except in the whole form, where the two horizontals run as
one paired launch (``"hpair"``) and, on a block whose shape the sweep
groups pay on (``groups_pay``), the three down directions and the three up
ones run as one launch each (``"vdown"``, ``"vup"``), each where the first
of its directions stands. It is a pure function of the call's steps, form
and block shape, so it is held here for every form, a range of step
subsets and shapes on both sides of the rule; the card tests hold the
launches themselves.
"""

from collections import Counter

import pytest

from stereo_tpu_torch.ops.cuda.sgm_kernel import (
    SWEEP_GROUPS,
    groups_pay,
    launch_plan,
)
from stereo_tpu_torch.ops.sgm import H_STEPS, PATH_STEPS, V_STEPS

DOWN, UP = (group for _, group in SWEEP_GROUPS)

#: Step subsets, and the forms of their launches in the whole form: on a
#: block where the groups pay, and on one where they do not.
SUBSETS = {
    "8_paths": (PATH_STEPS[:8], ["hpair", "vdown", "vup"],
                ["hpair"] + ["whole"] * 6),
    "4_paths": (PATH_STEPS[:4], ["hpair", "whole", "whole"],
                ["hpair", "whole", "whole"]),
    "horizontals": (H_STEPS, ["hpair"], ["hpair"]),
    "horizontals_reversed": (H_STEPS[::-1], ["hpair"], ["hpair"]),
    "verticals": (V_STEPS, ["whole", "whole"], ["whole", "whole"]),
    "verticals_then_horizontals": (V_STEPS + H_STEPS,
                                   ["whole", "whole", "hpair"],
                                   ["whole", "whole", "hpair"]),
    "horizontals_apart": (((1, 0), (0, -1), (1, 1), (0, 1)),
                          ["whole", "hpair", "whole"],
                          ["whole", "hpair", "whole"]),
    "one_horizontal": (((0, 1),), ["whole"], ["whole"]),
    "diagonals": (PATH_STEPS[4:8], ["whole"] * 4, ["whole"] * 4),
    "down_group": (DOWN, ["vdown"], ["whole"] * 3),
    "up_group_reordered": (UP[::-1], ["vup"], ["whole"] * 3),
    "missing_one_diagonal": (PATH_STEPS[:7],
                             ["hpair", "vdown", "whole", "whole"],
                             ["hpair"] + ["whole"] * 5),
    "groups_interleaved": (((1, 1), (-1, 0), (0, 1), (1, 0), (-1, -1),
                            (0, -1), (1, -1), (-1, 1)),
                           ["vdown", "vup", "hpair"],
                           ["whole", "whole", "hpair", "whole", "whole",
                            "whole", "whole"]),
    "8_paths_up_first": (PATH_STEPS[3::-1] + PATH_STEPS[4:8],
                         ["vup", "vdown", "hpair"],
                         ["whole", "whole", "hpair", "whole", "whole",
                          "whole", "whole"]),
}

FORMS = ["whole", "rect", "shear+1", "shear-1", "mask"]

#: Block shapes (h, w, d) and cost bytes on both sides of ``groups_pay``.
SHAPES = {"cfg4": ((1988, 2880, 256), 1, True),
          "cfg4_d128": ((1988, 2880, 128), 1, True),
          "kitti": ((375, 1242, 128), 1, False),
          "cfg4_int16": ((1988, 2880, 256), 2, False),
          "cfg4_d64": ((1988, 2880, 64), 1, False)}


@pytest.mark.parametrize("shape", sorted(SHAPES))
@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("subset", sorted(SUBSETS))
def test_launch_plan(form, subset, shape):
    steps, grouped, single = SUBSETS[subset]
    block, cost_bytes, pays = SHAPES[shape]
    plan = launch_plan(steps, form, block, cost_bytes)
    whole_forms = grouped if pays else single
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
    units = {"hpair": H_STEPS, "vdown": DOWN, "vup": UP}
    for launch in plan:
        if launch.form in units:
            assert form == "whole"
            assert launch.steps == units[launch.form]
        else:
            assert len(launch.steps) == 1
    # each launch stands where the first of its directions does, and the
    # single launches keep the call's order of directions
    firsts = [min(steps.index(st) for st in launch.steps) for launch in plan]
    assert firsts == sorted(firsts)


@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_groups_pay(shape):
    block, cost_bytes, pays = SHAPES[shape]
    assert groups_pay(*block, cost_bytes) is pays
