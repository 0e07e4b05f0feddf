"""Device milliseconds a frame of the progressive blend: the float
elementwise kernels that scale the framebuffer, weight the sample and add
it (profiler timeline; the renderer runs no other float multiply or add
on the card)."""
import re

BLEND = re.compile(r"elementwise.*(MulFunctor|AddFunctor|CUDAFunctor_add|"
                   r"MulScalarFunctor|AUnaryFunctor)<float")


def read(tr):
    if not tr["frames"]:
        return None
    t = [dur for name, _, dur, _ in tr["kernels"] if BLEND.search(name)]
    return sum(t) / 1e3 / tr["frames"] if t else None
