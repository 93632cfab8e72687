"""A configuration's ``extra_iters`` (the reference encoder's
``--ExtraGradientIter``) reaches the check and the roofline counts: at
416x240 with one extra iteration, the plain reference gives the port's
decisions, those of its eager pipeline on the CPU, for one frame-ref, and
they differ from VTM's iteration count; the counts add two refining
evaluates per mode for each extra iteration."""

import os

import pytest
import torch

from mebench import frames, reference, roofline, run
from vvc_affine_tpu_torch.models.pipeline import (AffineMEPipeline,
                                                  PipelineConfig)

torch.set_num_threads(2)

FW, FH = 416, 240


def test_reference_follows_extra_iters():
    mix = run.load_json(os.path.join(run.HERE, "mixes", "ld4_stream.json"))
    o, r = frames.stream(FW, FH, 1, 2**31 + 41, "cpu", mix["motion"])
    pipe = AffineMEPipeline(PipelineConfig(FW, FH, 32, extra_iters=1,
                                           device="cpu"))
    got = {reference.PREDS[res.pred]: (res.costs, res.cpmvs)
           for res in pipe.encode(o.numpy(), r.numpy())}
    assert len(got) == 4
    ref = r[0].to(torch.int32).reshape(-1)
    orig = o[0].to(torch.int32).reshape(-1)
    lam = reference.lambda_for(32, 1)
    want = reference.frame_ref(ref, orig, FW, FH, lam, extra_iters=1)
    vtm = reference.frame_ref(ref, orig, FW, FH, lam)
    for k, (c, p) in want.items():
        assert torch.equal(got[k][0], c) and torch.equal(got[k][1], p), k
    assert any(not torch.equal(want[k][1], vtm[k][1]) for k in want)


@pytest.mark.parametrize("extra,k1,k2", [(0, 20, 22), (1, 24, 26), (3, 32, 34)])
def test_roofline_counts_follow_extra_iters(extra, k1, k2):
    f = roofline.frame_ref(1920, 1080, extra_iters=extra)
    base = roofline.frame_ref(1920, 1080)
    assert (f["k1_launches"], f["k2_launches"]) == (k1, k2)
    assert f["k1_s"] == pytest.approx(base["k1_s"] * k1 / 20)
