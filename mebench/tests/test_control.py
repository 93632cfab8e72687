"""The control: the reference with its solver in float32 in place of the
program.  On the card, at the cells' own sizes, it differs from the
float64 reference and comes out not correct on every seed tried
(PERF.md); a float32 solve flips a decision only rarely, so at the small
size a CPU test can hold, these tests check that the control runs through
the harness's own window and check, and that its solver really computes
in float32."""

import pytest
import torch

from mebench import control, reference, run

torch.set_num_threads(2)


@pytest.mark.parametrize("cell", ["b1080_ld4_plane", "b1080_ld4_gather"])
def test_control_runs_through_the_harness(cell):
    """The control takes the program's place in a whole run on the CPU
    (128x128) and is judged by the run's own check, which reaches every
    frame-ref it draws; its decisions match the reference's or not."""
    _, _, cfg, mix = run.load_cell(cell)
    cfg = dict(cfg, frame_w=128, frame_h=128)
    mix = dict(mix, frames=5, check={"early": 1, "steady": 1})
    out = run.run_cell(cell, 2**31 + 11, 20.0, False,
                       device="cpu", config=cfg, mix=mix,
                       hook=control.float32_reference)
    assert out["checks"]["frame_refs_not_checked"]["value"] == 0
    assert out["correct"] == (out["checks"]["differing_decisions"]["value"] == 0)


def test_float32_solver_differs_from_float64():
    g = torch.Generator().manual_seed(3)
    A = torch.randint(-2**20, 2**20, (64, 6, 7), generator=g, dtype=torch.int64)
    A[:, :, :6] = A[:, :, :6] @ A[:, :, :6].transpose(1, 2) // 1024  # symmetric
    x64 = reference._solve(A, 3, torch.float64)
    x32 = reference._solve(A, 3, torch.float32)
    assert x32.dtype == torch.float32
    assert not torch.equal(x32.double(), x64)
