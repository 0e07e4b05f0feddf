"""Scenes without glass go through the reference's arithmetic unchanged:
on one CPU record of each sponza cell, the reference's outputs equal, bit
for bit, those of the reference before it followed glass, frozen here as a
digest of its ``values`` and ``segments`` on the same record."""
import hashlib

import numpy as np
import pytest

from rtbench import harness, manifest
from rtbench.reference import compare

#: (cell, seed, size) -> sha256 of the reference's outputs on the record,
#: computed with the reference that had no glass. The moving cell's digest
#: is that of the 960x540 moving cell it replaced: at the record's size
#: the size wins over the mix's own (``traffic.params``), so the two mixes
#: drive the same frames
FROZEN = {
    ("sponza268k.still", 2 ** 31 + 9, (48, 27)):
        "24376a0b5dcd2ca278a89102e47306db0d66e8750c68fc793d0cad340f6a6f15",
    ("sponza268k.orbit1440", 2 ** 31 + 10, (64, 36)):
        "3cd6d6f87eb91087d7c44488f78286634f63b58782f1ed128cef5c46b1ff53b6",
}


def digest(ref: dict) -> str:
    h = hashlib.sha256(np.ascontiguousarray(ref["values"], np.float32)
                       .tobytes())
    h.update(str(int(ref["segments"])).encode())
    return h.hexdigest()


def outputs(cell_name: str, seed: int, size: tuple) -> dict:
    """The reference's outputs on a record of a window of no length: the
    mix's warm frames and one frame more, so the record does not depend on
    the host's speed."""
    cell = manifest.cell(manifest.load(), cell_name)
    run, inputs = harness.drive(cell, seed, 0.0, False, "cpu", size)
    assert run["n_frames"] == 5
    return compare.reference_outputs(inputs, run, "cpu")


@pytest.mark.parametrize("key", list(FROZEN), ids=[k[0] for k in FROZEN])
def test_the_reference_is_unchanged_on_sponza(key):
    assert digest(outputs(*key)) == FROZEN[key]
