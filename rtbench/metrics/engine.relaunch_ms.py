"""Host milliseconds a frame from the end of ``Engine.update``'s wait for
the frame before (the program's span ``engine.settle.wait``, the last of
update k) to the end of the next frame's record (``engine.event`` of
update k + 1): the host's relaunch after the wait, while the card runs the
one frame it still holds. Where it outlasts the card's frame the card
idles. The mean over the frames that have both."""
from rtbench.program_spans import last_session


def relaunches(rec: dict) -> list:
    """The relaunch of each update k whose wait has a next frame's record,
    in ms, in the order of k."""
    waits, events = {}, {}
    for name, _, frame, _, end in rec["spans"]:
        if end is None:
            continue
        if name == "engine.settle.wait":
            waits[frame] = max(end, waits.get(frame, end))
        elif name == "engine.event":
            events[frame] = end
    return [(events[k + 1] - end) / 1e6 for k, end in sorted(waits.items())
            if k + 1 in events]


def read(tr):
    rec = last_session()
    gaps = relaunches(rec) if rec is not None else []
    return sum(gaps) / len(gaps) if gaps else None
