"""The reference against the program on the CPU, small: the plain
versions of the port's kernels and the reference trace the same paths.
And the control (the reference in bfloat16) is judged not correct."""
import numpy as np
import pytest
import torch

from rtbench import harness, manifest
from rtbench.reference import compare


def record(cell_name, seed, size=(48, 27), seconds=0.5):
    cell = manifest.cell(manifest.load(), cell_name)
    return harness.drive(cell, seed, seconds, False, "cpu", size)


def test_still_accumulation_matches():
    """Every frame's path of the sampled pixels accumulated as the renderer
    does. At this size a few paths whose closest hit lies on an edge two
    triangles share take the other triangle in the plain version (1-2 of
    the last frame's 1,296), so the bounds are the orbit's below; at the
    card's size sound runs read under the cell's limits."""
    run, inputs = record("sponza268k.still", 2 ** 31 + 5)
    ref = compare.reference_outputs(inputs, run, "cpu")
    assert run["n_frames"] >= 5
    found = compare.numbers(run["values"], ref["values"],
                            run["last_segments"], ref["segments"])
    assert found["mismatch_share"] <= 0.02 and found["segments_gap"] <= 0.01


def test_orbit_camera_is_replayed_from_the_deltas():
    run, inputs = record("sponza268k.orbit1440", 11, size=(64, 36),
                         seconds=1.0)
    ref = compare.reference_outputs(inputs, run, "cpu")
    assert len(run["deltas"]) == run["n_frames"] >= 6
    found = compare.numbers(run["values"], ref["values"],
                            run["last_segments"], ref["segments"])
    assert found["mismatch_share"] <= 0.02 and found["segments_gap"] <= 0.01


def test_the_control_is_not_correct():
    run, inputs = record("sponza268k.still", 3)
    ref = compare.reference_outputs(inputs, run, "cpu")
    ctl = compare.reference_outputs(inputs, run, "cpu", torch.bfloat16)
    found = compare.numbers(ctl["values"], ref["values"], ctl["segments"],
                            ref["segments"])
    limits = manifest.cell_data("sponza268k.still")["limits"]
    correct, _ = compare.judge(found, limits)
    assert not correct


def test_a_missing_limit_fails():
    ok, checks = compare.judge(dict(mismatch_share=0.0), {})
    assert not ok and checks["mismatch_share"]["limit"] is None


def test_blend_weights_are_the_renderers():
    w = compare.blend_weights(4)
    assert w.dtype == np.float32 and w[0] == 1 and w[3] == np.float32(0.25)
    s = np.ones((3, 2, 4), np.float32) * np.arange(1, 4, dtype=np.float32
                                                   )[:, None, None]
    assert np.allclose(compare.accumulate(s), 2.0)


@pytest.mark.cuda
def test_a_short_run_on_the_card_is_correct(card):
    out, _ = harness.run_cell("sponza268k.still", 17, 1.0, False)
    assert out["correct"], out["checks"]
