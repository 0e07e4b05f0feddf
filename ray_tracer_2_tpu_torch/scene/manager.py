"""Background scene loading (port of ``ray_tracer_2_tpu/scene/manager.py``;
ref: SceneManager, scene.rs:109-146).

A daemon thread takes scene requests from a queue, reads the assets and
builds the tables on the host, moves the finished scene to the manager's
device once (``HostScene.to``) and queues it; ``poll_loaded`` hands it to
the render loop without waiting (app.rs:135-142). A scene that fails to
load (an ``AssetNotFound`` for a file the repository lacks) is logged and
leaves the current scene in place.
"""
from __future__ import annotations

import logging
import queue
import threading

import torch

from ray_tracer_2_tpu_torch.accel.bvh import BVHQuality
from ray_tracer_2_tpu_torch.scene.render_scene import (
    HostScene, instantiate_host_scene,
)

log = logging.getLogger(__name__)


class SceneManager:
    def __init__(self, assets=None, device="cuda"):
        if assets is None:
            from ray_tracer_2_tpu_torch.assets.manager import AssetManager
            assets = AssetManager()
        self.assets = assets
        self.device = torch.device(device)
        self.scene: HostScene | None = None
        self.selected_scene = None
        self.bvh_quality = BVHQuality.HIGH
        self._requests: queue.Queue = queue.Queue()
        self._loaded: queue.Queue = queue.Queue()
        self._thread = threading.Thread(target=self._loader_loop, daemon=True)
        self._thread.start()

    def _loader_loop(self) -> None:
        from ray_tracer_2_tpu_torch.scene.scenes import build_scene_definition

        while True:
            req = self._requests.get()
            if req is None:
                return
            name, quality = req
            try:
                definition = build_scene_definition(name, self.assets)
                host = instantiate_host_scene(definition, self.assets,
                                              quality=quality)
                self._loaded.put((name, host.to(self.device)))
            except Exception:  # report a failed load, keep the loader alive
                log.exception("scene load failed: %s", name)
                self._loaded.put((name, None))

    def request_scene(self, name,
                      quality: BVHQuality = BVHQuality.HIGH) -> None:
        """Queue an asynchronous scene load (scene.rs:140-146); ``quality``
        is the BVH builds' (egui.rs:404-460)."""
        log.info("Loading Scene: %s", name)
        self.selected_scene = name
        self.bvh_quality = quality
        self._requests.put((name, quality))

    def poll_loaded(self) -> HostScene | None:
        """The scene loaded since the last poll, or None; never waits
        (app.rs:135-142 try_recv). A failed load gives None and keeps the
        current scene."""
        try:
            _, host = self._loaded.get_nowait()
        except queue.Empty:
            return None
        if host is not None:
            self.scene = host
        return host

    def rebuild_bvh(self, quality: BVHQuality) -> None:
        """Reload the current scene with its BVHs built at ``quality``
        (egui.rs:404-460, the rebuild button)."""
        if self.selected_scene is not None:
            self.request_scene(self.selected_scene, quality)

    def load_blocking(self, name,
                      quality: BVHQuality = BVHQuality.HIGH) -> HostScene:
        self.request_scene(name, quality)
        while True:
            got = self._loaded.get()
            if got[0] == name:
                if got[1] is None:
                    raise RuntimeError(f"scene load failed: {name}")
                self.scene = got[1]
                return got[1]

    def shutdown(self) -> None:
        self._requests.put(None)
