"""The program's own record of a traced window, for the readers of the
metrics it feeds: the last profiler session of
``ray_tracer_2_tpu_torch.spans``. The harness enters the profiler after
the warm frames and their ``synchronize`` and leaves it after the window's,
so that session is the window, frame for frame."""


def last_session():
    """The session's record (``spans.record()``), or None where the program
    has no spans of its own (a tree before them) or the session holds no
    ``Engine.update``."""
    try:
        from ray_tracer_2_tpu_torch import spans
    except ImportError:
        return None
    rec = spans.record()
    return rec if rec["totals"].get("engine.update") else None


def ms_per_frame(name: str):
    """Milliseconds a frame inside the program's span ``name``: its total
    over the number of ``engine.update`` spans; None where it never ran."""
    rec = last_session()
    if rec is None or name not in rec["totals"]:
        return None
    return rec["totals"][name]["ms"] / rec["totals"]["engine.update"]["n"]
