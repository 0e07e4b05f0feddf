"""Host milliseconds a frame from the end of the wait for the last frame
(the program's span ``engine.settle.wait``) to the end of the frame's first
megakernel launch after it (``megakernel.launch``): the host work the idle
card waits on. The mean over the frames that have both."""
from rtbench.program_spans import last_session


def read(tr):
    rec = last_session()
    if rec is None:
        return None
    waits, gaps = {}, []
    for name, _, frame, _, end in rec["spans"]:
        if end is None:
            continue
        if name == "engine.settle.wait":
            waits.setdefault(frame, end)
        elif name == "megakernel.launch" and frame in waits:
            gaps.append(end - waits.pop(frame))
    return sum(gaps) / len(gaps) / 1e6 if gaps else None
