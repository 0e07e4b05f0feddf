"""A run whose timed path is broken underneath is not correct. Each test
skips only the look for a card: it drives the rest of a run on the CPU at
a small size, with one fault of ``rtbench.faults`` planted in the
program's path:

* a frame that leaves the framebuffer as it was (the state unchanged);
* half of each frame's rows left out;
* an answer altered where it is produced (every sample a little off).

Each fault is planted on the sponza cells, whose frames take the
megakernel, and on a cell whose frames take the small-scene kernel (a
configuration added as data alone, ``test_rtbench_manifest``).

The exchange between cards does not exist in a one-card cell."""
import pytest

from rtbench import faults, harness
from test_rtbench_manifest import small_root, small_run  # noqa: F401

SIZE = (48, 27)


@pytest.fixture
def planted():
    hooks = []

    def plant(name):
        hooks.append(faults.plant(name))
        return hooks[-1]
    yield plant
    for h in hooks:
        h.undo()


def run(cell, hook):
    out, _ = harness.run_cell(cell, 2 ** 31 + 77, 0.5, False, device="cpu",
                              size=SIZE, hook=hook)
    return out


def test_state_left_unchanged(planted):
    assert not run("sponza268k.still", planted("unchanged"))["correct"]


def test_half_the_rows_left_out(planted):
    assert not run("sponza268k.still", planted("half_rows"))["correct"]


@pytest.mark.parametrize("cell", ["sponza268k.still",
                                  "sponza268k.orbit1440"])
def test_answer_altered(planted, cell):
    assert not run(cell, planted("altered"))["correct"]


@pytest.mark.parametrize("fault", faults.NAMES)
def test_faults_on_the_small_scene_kernel(fault, small_root, monkeypatch):
    """Every pixel of the small-scene cell's frame: the fault makes the run
    not correct, and once it is undone a run is correct again."""
    hook = faults.plant(fault)
    try:
        out = small_run(small_root, 2 ** 31 + 78, monkeypatch, hook)
    finally:
        hook.undo()
    assert not out["correct"], out["checks"]
    out = small_run(small_root, 2 ** 31 + 79, monkeypatch)
    assert out["correct"], out["checks"]
