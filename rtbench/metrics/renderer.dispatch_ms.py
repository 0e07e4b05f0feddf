"""Host milliseconds a frame inside ``Renderer.render``: preparing the
frame, routing, the kernel tables, the launch and the blend's queueing
(a span the benchmark wraps around the call)."""


def read(tr):
    r = (tr["spans"] or {}).get("renderer.render", [])
    return sum(r) / len(r) * 1e3 if r else None
