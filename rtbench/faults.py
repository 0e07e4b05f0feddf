"""Faults planted in the program's timed path, to show that the comparison
catches them: each is a hook for ``harness.drive`` (called with the
engine before the warm frames) and an ``undo`` that takes it out again.

* ``unchanged``: from the third frame on, a frame renders and blends as
  ever, and then the framebuffer is put back as it was (a step that
  returns its state unchanged);
* ``half_rows``: every frame's sample has its top half of rows left out
  (zero) and half its segments;
* ``altered``: every sample 2% off in its red channel, where it is
  produced.

A one-card cell has no exchange between cards to leave out.

    python3 -m rtbench.control --workload <cell> --seconds <s> --seeds <n> ... --fault <name>

reads them at a cell's own size and window on the card."""
from __future__ import annotations


def _unchanged(eng) -> None:
    render = eng.renderer.render
    calls = []

    def stuck(scene, params):
        calls.append(1)
        if len(calls) <= 2:
            return render(scene, params)
        before = eng.renderer.framebuffer.clone()
        fb = render(scene, params)
        fb.copy_(before)
        return fb
    eng.renderer.render = stuck


def _half(orig):
    def half(scene, frames, **kw):
        img, segs = orig(scene, frames, **kw)
        img = img.clone()
        img[: img.shape[0] // 2] = 0.0
        return img, segs // 2
    return half


def _off(orig):
    def off(scene, frames, **kw):
        import torch
        img, segs = orig(scene, frames, **kw)
        return img * torch.tensor([1.02, 1.0, 1.0, 1.0],
                                  device=img.device), segs
    return off


NAMES = ("unchanged", "half_rows", "altered")


def plant(name: str):
    """The hook of fault ``name``; call its ``undo`` after the run."""
    if name == "unchanged":
        def hook(eng):
            _unchanged(eng)
        hook.undo = lambda: None
        return hook
    change = {"half_rows": _half, "altered": _off}[name]

    def hook(eng):
        import ray_tracer_2_tpu_torch.engine.renderer as r
        orig = r.render_persistent
        hook.undo = lambda: setattr(r, "render_persistent", orig)
        r.render_persistent = change(orig)
    hook.undo = lambda: None
    return hook
