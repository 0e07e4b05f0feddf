"""The one generator of traffic: it reads a mix's data file
(``traffic/<name>.json``) and makes each frame's input from the seed.

A mix states:

* ``loop``: ``closed`` (each ``Engine.update`` starts when the last
  returned; the only loop there is so far);
* ``dt``: the fixed seconds each frame passes to ``Engine.update``;
* ``warm_frames``: the frames run before the window, in set-up;
* ``params`` (optional): ``RenderParams`` fields the Engine starts from,
  over the README's defaults (1920x1080, 5 bounces, 1 ray a pixel, skybox
  on, accumulation on, no NEE, antialias or normal maps); only the fields
  the reference replays (``reference.compare.REPLAYED``) may be set;
* ``mouse`` (optional; none for a still camera): the turns sent through
  ``CameraController.process_mouse`` before each frame, which then runs
  with ``is_moving=True``. Each block of ``block`` frames uses the listed
  ``dx`` values once each in an order drawn from the seed, and the
  vertical deltas in pairs, ``+a`` then ``-a`` for each ``a`` of
  ``dy_pairs`` in a seeded order and with a seeded sign. So every seed
  sends the same set of turns, and the pitch never strays more than one
  delta from where it started: the view sweeps the same band of the scene
  whatever the seed."""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from rtbench.reference.compare import REPLAYED

HERE = Path(__file__).resolve().parent
#: the Engine's frame (engine.rs:202 ``RENDER_SIZE``)
WIDTH, HEIGHT = 1920, 1080


def load(name: str, root: Path = HERE) -> dict:
    mix = json.loads((root / "traffic" / f"{name}.json").read_text())
    if mix.get("loop", "closed") != "closed":
        raise ValueError(f"mix {name!r}: only a closed loop is driven")
    other = set(mix.get("params", {})) - set(REPLAYED)
    if other:
        raise ValueError(f"mix {name!r} sets {sorted(other)}, which the "
                         f"reference does not replay")
    return mix


def params(mix: dict, size: tuple | None = None) -> dict:
    """The ``RenderParams`` fields the Engine starts from: the frame size
    (``size`` in its place, for small runs on the CPU) and the mix's own."""
    out = {"width": WIDTH, "height": HEIGHT, **mix.get("params", {})}
    if size is not None:
        out["width"], out["height"] = size
    return out


class Mouse:
    """The seeded stream of (dx, dy) deltas of a mix's ``mouse``; every
    delta handed out is kept in ``sent``."""

    def __init__(self, mouse: dict, seed: int):
        self.mouse = mouse
        self.rng = np.random.default_rng(int(seed) & (2 ** 63 - 1))
        self.sent: list[tuple[float, float]] = []
        self._block: list[tuple[float, float]] = []

    def next(self) -> tuple[float, float]:
        if not self._block:
            dx = np.asarray(self.mouse["dx"], np.float64)
            pairs = np.asarray(self.mouse["dy_pairs"], np.float64)
            n = int(self.mouse["block"])
            if len(dx) != n or 2 * len(pairs) != n:
                raise ValueError("a block lists one dx a frame and one "
                                 "dy pair for two frames")
            a = self.rng.permutation(pairs) \
                * self.rng.choice([-1.0, 1.0], size=len(pairs))
            dy = np.stack([a, -a], axis=1).reshape(-1)
            self._block = list(zip(self.rng.permutation(dx).tolist(),
                                   dy.tolist()))
        delta = self._block.pop(0)
        self.sent.append(delta)
        return delta


class Frames:
    """A mix's per-frame input to an engine: ``step()`` turns the camera
    where the mix moves it, then runs one ``Engine.update``."""

    def __init__(self, mix: dict, seed: int, eng):
        self.eng = eng
        self.dt = float(mix["dt"])
        self.moving = "mouse" in mix
        self.mouse = Mouse(mix["mouse"], seed) if self.moving else None
        self.controller = eng.scene_manager.scene.camera.controller

    def step(self) -> None:
        if self.moving:
            self.controller.process_mouse(*self.mouse.next())
        self.eng.update(self.dt, is_moving=self.moving)

    @property
    def sent(self) -> list:
        return list(self.mouse.sent) if self.moving else []
