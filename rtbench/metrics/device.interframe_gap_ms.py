"""Device milliseconds a frame in which the card waits between frames: the
card's own clock from one frame's end event to the next frame's first
launch (the program's counter ``device.interframe_gap_ms``, the mean over
cards), over the gaps it counted."""
from rtbench.program_spans import last_session


def read(tr):
    rec = last_session()
    c = rec["counters"] if rec is not None else {}
    if not c.get("device.interframe_gaps"):
        return None
    return c["device.interframe_gap_ms"] / c["device.interframe_gaps"]
