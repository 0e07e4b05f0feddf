"""Device nanoseconds of the megakernel (``csrc/megakernel.cu``, every
form: ``render_single``, ``render_general*``) per exact traced segment of
the window."""
import re

MEGAKERNEL = re.compile(r"\brender_(single|general)")


def read(tr):
    t = sum(dur for name, _, dur, _ in tr["kernels"] if MEGAKERNEL.search(name))
    if not t or not tr["segments"]:
        return None
    return t * 1e3 / tr["segments"]
