"""Host milliseconds a frame inside ``Engine.update`` outside
``Renderer.render`` and outside the wait in ``Engine._settle_pending``:
the frame loop's own work (spans the benchmark wraps around the calls)."""


def read(tr):
    s = tr["spans"] or {}
    upd = s.get("engine.update", [])
    if not upd:
        return None
    rest = sum(upd) - sum(s.get("renderer.render", [])) \
        - sum(s.get("engine.settle", []))
    return rest / len(upd) * 1e3
