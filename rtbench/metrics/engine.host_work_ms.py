"""Host milliseconds a frame of ``Engine.update``'s own work: the
program's span ``engine.update`` less the part of it blocked on the card
(``engine.settle.wait``), the mean over the window's updates. Set beside
the card's frame it says which side sets the pace: where it is the
longer, the card waits for the host."""
from rtbench.program_spans import last_session


def read(tr):
    rec = last_session()
    if rec is None:
        return None
    t = rec["totals"]
    wait = t.get("engine.settle.wait", {}).get("ms", 0.0)
    return (t["engine.update"]["ms"] - wait) / t["engine.update"]["n"]
