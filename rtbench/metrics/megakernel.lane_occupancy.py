"""The megakernel's lane occupancy over the window: lanes holding a path
summed over the turns of every warp's lane loop, over 32 lanes a turn (the
kernel's own device counts ``active_lanes`` and ``turns``, their change
over the traced window)."""
from rtbench.program_spans import last_session


def read(tr):
    rec = last_session()
    c = rec["counts"].get("megakernel") if rec is not None else None
    if not c or not c["turns"]:
        return None
    return 100.0 * c["active_lanes"] / (32 * c["turns"])
