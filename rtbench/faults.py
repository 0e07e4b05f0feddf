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

The two that act on the sample wrap the entry of every render kernel
that ``renderer.render_sample`` routes to, the megakernel and the
small-scene kernel alike.

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


def _sample_entries() -> list:
    """(module, name) of each kernel entry through which
    ``renderer.render_sample`` reaches a frame's sample: the megakernel's,
    a global of the renderer, and the small-scene kernel's, an attribute of
    its module. A fault wraps them all, so it acts whichever kernel the
    cell's frames take."""
    import ray_tracer_2_tpu_torch.engine.renderer as r
    return [(r, "render_persistent"), (r.spheres, "render_spheres")]


def plant(name: str):
    """The hook of fault ``name``; call its ``undo`` after the run."""
    if name == "unchanged":
        def hook(eng):
            _unchanged(eng)
        hook.undo = lambda: None
        return hook
    change = {"half_rows": _half, "altered": _off}[name]

    def hook(eng):
        entries = [(m, n, getattr(m, n)) for m, n in _sample_entries()]

        def undo():
            for m, n, orig in entries:
                setattr(m, n, orig)
        hook.undo = undo
        for m, n, orig in entries:
            setattr(m, n, change(orig))
    hook.undo = lambda: None
    return hook
