"""Host milliseconds a frame that ``Engine.update`` is blocked on the card,
waiting for the last frame's events (the program's span
``engine.settle.wait``)."""
from rtbench.program_spans import ms_per_frame


def read(tr):
    return ms_per_frame("engine.settle.wait")
