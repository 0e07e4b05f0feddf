"""Interior wide-BVH rows the megakernel visits a traced segment: the
kernel's own device count ``rows``, its change over the traced window, over
the window's exact segments."""
from rtbench.program_spans import last_session


def read(tr):
    rec = last_session()
    c = rec["counts"].get("megakernel") if rec is not None else None
    if not c or not tr["segments"]:
        return None
    return c["rows"] / tr["segments"]
