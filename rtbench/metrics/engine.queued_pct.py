"""Share of the window's frames that the card reached with no host gap:
frames whose frame before was still unfinished on the card when
``Engine.update`` recorded their events (the program's counters
``engine.dispatches_queued`` over ``engine.dispatches``), in percent."""
from rtbench.program_spans import last_session


def read(tr):
    rec = last_session()
    c = rec["counters"] if rec is not None else {}
    if not c.get("engine.dispatches"):
        return None
    return 100.0 * c.get("engine.dispatches_queued", 0) \
        / c["engine.dispatches"]
