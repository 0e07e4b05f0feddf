"""The megakernel's share of its roofline: the least time the card could
take for the cell's frozen work (operations a segment times the window's
exact segments, over 67 TFLOP/s; the tables read once and the image
written once a frame, over 3.35 TB/s; the larger), over the megakernel's
device time in the window."""
import re

from rtbench.frozen.work import bound_s

MEGAKERNEL = re.compile(r"\brender_(single|general)")


def read(tr):
    work = tr["work"]
    t = sum(dur for name, _, dur, _ in tr["kernels"] if MEGAKERNEL.search(name))
    if not work or not t or not tr["segments"]:
        return None
    ops = work["ops_per_segment"] * tr["segments"]
    nbytes = work["bytes_per_frame"] * tr["frames"]
    return 100.0 * bound_s(ops, nbytes) / (t / 1e6)
