"""The control comes out not correct: the plain reference with TF32 on, put
in the program's place, fails the cell's limits.  On the card only (TF32
does not exist on the CPU); at a size a test run holds, the full-size
readings are ``calibrate.py``'s (PERF.md)."""
import time

import pytest
import torch

from slambench import harness
from slambench.reference import check
from slambench.tests.tiny import tiny_spec


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["replica_semantic.posed_300k"])
def test_control_is_not_correct(cell):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: TF32 is a precision of the card")
    spec = tiny_spec(cell, n=60000)
    spec["config"]["frames"].update(W=320, H=240, fx=160.0, fy=160.0, cx=159.5, cy=119.5)
    spec["config"]["set"]["map_capacity"] = 400_000   # frame 0 alone inserts 76,800
    dev = torch.device("cuda", 0)
    res = harness.run_cell(spec, 2**31 + 11, None, False, time.time(), dev, log=lambda s: None)
    prog, ref = res["observations"]
    assert res["correct"], res["check"]
    ctl = check.reference_observations(res["inputs"], prog, dev, tf32=True)
    nums = check.numbers(check.in_program_place(prog, ctl), ref)
    tracks = prog["track"] is not None
    expected = check.expected_numbers(spec["limits"], tracks)
    checked = check.judge(nums, spec["limits"], expected)
    assert not check.correct(checked), checked
