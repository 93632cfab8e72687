"""The roofline counts against a hand count, and the frozen CU geometry
against the program's (which the counts and the reference never read)."""

import ast
import os

import pytest

from mebench import geometry, roofline, run
from vvc_affine_tpu_torch import geometry as port_geometry


def test_hand_count_one_ctu():
    """128x128, one CTU: every aligned class tiles it, 12 x 16384 samples
    in 201 CUs per evaluate."""
    n, s = roofline.inside("full", 128, 128)
    assert (n, s) == (201, 12 * 128 * 128)
    t, bound = roofline.k1("full", 128, 128)
    want_bytes = 128 * 128 * 2 + 201 * 24 + s * 2
    want_ops = s * 24
    assert t == max(want_bytes / 3.35e12, want_ops / 67e12)
    assert bound == ("bytes" if want_bytes / 3.35e12 >= want_ops / 67e12 else "ops")
    t2, _ = roofline.k2("full", 128, 128, refine=True)
    assert t2 == max((s * 2 + 128 * 128 * 2 + (s // 16) * 24) / 3.35e12,
                     s * 25 / 67e12)
    t3, _ = roofline.k2("full", 128, 128, refine=False)
    assert t3 == max((s * 2 + 128 * 128 * 2 + (s // 16) * 4) / 3.35e12,
                     s * 7 / 67e12)


def test_half_and_partial_ctus():
    """Half-aligned: 284 CUs per CTU; a CU past the frame edge is not
    predicted (1920x1080: the bottom CTU row is 56 rows high)."""
    assert geometry.cus_per_ctu("half") == 284
    n, s = roofline.inside("half", 128, 128)
    assert n == 284 and s == sum(c.width * c.height * c.num_cus
                                 for c in geometry.classes("half"))
    n1080, _ = roofline.inside("full", 1920, 1080)
    assert n1080 < 135 * 201


def test_frame_ref_launches():
    """Per mode 10 K1 (2CP evaluates 1-5, 3CP 0-4) and 11 K2 (9
    refining, 2 SATD only): 20 and 22 per frame-ref."""
    f = roofline.frame_ref(1920, 1080)
    assert (f["k1_launches"], f["k2_launches"]) == (20, 22)
    assert f["k1_s"] > 0 and f["k2_s"] > 0


@pytest.mark.parametrize("mode", ["full", "half"])
def test_geometry_copy_equals_the_programs(mode):
    mine = geometry.classes(mode)
    port = port_geometry.layout(mode).classes
    assert [(c.name, c.width, c.height, c.xs, c.ys) for c in mine] == \
        [(c.name, c.width, c.height, c.xs, c.ys) for c in port]


def test_counts_read_no_table_of_the_program():
    for name in ("roofline.py", "geometry.py"):
        tree = ast.parse(open(os.path.join(run.HERE, name)).read())
        mods = {n.module for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)}
        mods |= {a.name for n in ast.walk(tree) if isinstance(n, ast.Import) for a in n.names}
        assert not any(m and m.split(".")[0] == "vvc_affine_tpu_torch" for m in mods)
