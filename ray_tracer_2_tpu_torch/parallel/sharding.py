"""Multi-card rendering over a mesh of torch devices (port of
``ray_tracer_2_tpu/parallel/sharding.py``).

One process drives every device of a ``RenderMesh``, as the reference's
single controller drives ``jax.devices()``; there is no
``torch.distributed`` group and no per-rank loop. Launches go to each
device's current stream with no host synchronisation between them, so
several cards render at once. The three layouts of the reference:

* **Row tiles** (``render_frame_sharded``; the default of ``Renderer``):
  device i renders the ``height / n`` rows of block i into its own block
  of the framebuffer (``ShardedFramebuffer``). The RNG seeds come from
  pixel ids, so no tile reads another: the sharded frame is the
  single-device frame, bit for bit on the card. The segment counts are
  summed in int64 on the first (home) device.
* **Sample rounds** (``render_frame_spp_sharded``): device i renders the
  whole image at RNG frame ``frames * n + i``; the n images are summed on
  the home device in device order and divided by n, as ``pmean``, and the
  round is blended as n frames.
* **The 2-D mesh** (``rows`` x ``spp``, ``render_frame_hybrid_sharded``):
  device (i, j) renders row block i at RNG frame ``frames * S + j``; the S
  samples of a block are averaged on its row's first device and blended at
  ``1 / (frames + 1)``.

Every layout renders through the port's own routing
(``engine/renderer.py:render_sample``): both render kernels and the debug
kernel take a row window, so small scenes keep ``csrc/spheres.cu`` under a
mesh (the reference sends them to its XLA megakernel there, because Mosaic
needs a static ``row_start``). A mesh may name one device several times:
its tiles then run one after another on that device, which is how one card
(or the CPU, in the tests) checks the layouts. The scene is copied once to
each distinct device (``SceneReplicas``) and kept in step with the writes
that live edits and camera moves make in place (``TorchScene.writes``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ray_tracer_2_tpu_torch.engine.renderer import (
    blend, blend_weight, render_sample,
)
from ray_tracer_2_tpu_torch.scene.render_scene import (
    DERIVED_ON_EDIT, TABLE_WRITES, TENSORS, TorchScene, drop_derived,
)


def _device(d) -> torch.device:
    """``d`` as a ``torch.device``, a CUDA one with its index; raises
    ``RuntimeError`` for a CUDA device this host does not have."""
    dev = torch.device(d)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(f"mesh device {dev}: this host has no CUDA card")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index >= torch.cuda.device_count():
        raise RuntimeError(f"mesh device {dev}: this host has "
                           f"{torch.cuda.device_count()} CUDA card(s)")
    return torch.device("cuda", index)


def _cards() -> list:
    """Every CUDA card of the host, in index order."""
    if not torch.cuda.is_available():
        raise RuntimeError("this host has no CUDA card: name the mesh's "
                           "devices, e.g. devices=['cpu'] * 4")
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


@dataclasses.dataclass(frozen=True)
class RenderMesh:
    """Devices over one axis, ``rows``, or two, ``rows`` x ``spp``
    (row-major: the devices of row i are ``devices[i * spp:(i + 1) *
    spp]``). A device may appear more than once. The first is the home
    device: the frame's segment count, a sample round's mean and the
    gathered framebuffer live there."""

    devices: tuple
    axes: tuple = ("rows",)
    sizes: tuple = ()

    def __post_init__(self):
        if self.axes not in (("rows",), ("rows", "spp")) \
                or len(self.sizes) != len(self.axes) \
                or min(self.sizes, default=0) < 1 \
                or int(np.prod(self.sizes)) != len(self.devices):
            raise ValueError(f"bad mesh: axes {self.axes}, sizes "
                             f"{self.sizes}, {len(self.devices)} devices")

    @property
    def shape(self) -> dict:
        """Axis name -> size (the reference's ``Mesh.shape``)."""
        return dict(zip(self.axes, self.sizes))

    @property
    def rows(self) -> int:
        return self.sizes[0]

    @property
    def home(self) -> torch.device:
        return self.devices[0]

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The distinct devices, in mesh order."""
        return tuple(dict.fromkeys(self.devices))

    def at(self, i: int, j: int = 0) -> torch.device:
        """The device of row i (and sample j on a 2-D mesh)."""
        return self.devices[i * (self.size // self.rows) + j]


def make_render_mesh(n_devices: int | None = None,
                     devices=None) -> RenderMesh:
    """1-D mesh over the ``rows`` axis: the first ``n_devices`` of
    ``devices`` (every CUDA card by default)."""
    devices = _cards() if devices is None else [_device(d) for d in devices]
    if n_devices is not None:
        if not 1 <= n_devices <= len(devices):
            raise ValueError(f"a mesh of {n_devices} devices from "
                             f"{len(devices)}")
        devices = devices[:n_devices]
    return RenderMesh(tuple(devices), ("rows",), (len(devices),))


def make_render_mesh2d(rows: int, spp: int, devices=None) -> RenderMesh:
    """2-D mesh (``rows`` x ``spp``) over the first ``rows * spp`` of
    ``devices`` (every CUDA card by default)."""
    devices = _cards() if devices is None else [_device(d) for d in devices]
    if rows * spp > len(devices):
        raise ValueError(f"mesh {rows}x{spp} needs {rows * spp} devices, "
                         f"have {len(devices)}")
    return RenderMesh(tuple(devices[:rows * spp]), ("rows", "spp"),
                      (rows, spp))


def auto_mesh(height: int, device="cuda") -> RenderMesh | None:
    """The mesh ``Renderer`` adopts by default: a rows mesh over the
    distinct CUDA cards, ``device`` first, trimmed until ``height``
    divides. None on one card, or when ``device`` is not a CUDA card."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        return None
    n = torch.cuda.device_count()
    while n > 1 and height % n != 0:
        n -= 1
    if n <= 1:
        return None
    home = _device(dev)
    return make_render_mesh(n, [home] + [d for d in _cards() if d != home])


# --------------------------------------------------------------------------
# the framebuffer on a mesh
# --------------------------------------------------------------------------
class ShardedFramebuffer:
    """An (H, W, 4) float32 accumulation buffer held as one block of
    ``H / rows`` rows for each row of a mesh, on that row's first device.
    It stands in for the tensor where the port's consumers read or fill
    one: ``shape``, ``copy_`` (scatters a whole buffer into the blocks),
    ``cpu``, ``numpy`` and ``np.asarray`` (gather to the host) and
    ``gather`` (to the home device)."""

    def __init__(self, blocks, mesh: RenderMesh):
        self.blocks = list(blocks)
        self.mesh = mesh

    @property
    def shape(self) -> torch.Size:
        rows = sum(b.shape[0] for b in self.blocks)
        return torch.Size((rows, *self.blocks[0].shape[1:]))

    @property
    def device(self) -> torch.device:
        return self.mesh.home

    def gather(self) -> torch.Tensor:
        """The whole buffer as one tensor on the home device."""
        return torch.cat([b.to(self.device, non_blocking=True)
                          for b in self.blocks])

    def copy_(self, src) -> "ShardedFramebuffer":
        """Copy the whole buffer ``src`` ((H, W, 4), any device) into the
        blocks."""
        if tuple(src.shape) != tuple(self.shape):
            raise ValueError(f"copy of a {tuple(src.shape)} buffer into "
                             f"{tuple(self.shape)}")
        r = 0
        for b in self.blocks:
            b.copy_(src[r:r + b.shape[0]], non_blocking=True)
            r += b.shape[0]
        return self

    def cpu(self) -> torch.Tensor:
        return torch.cat([b.cpu() for b in self.blocks])

    def numpy(self) -> np.ndarray:
        return self.cpu().numpy()

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        return a if dtype is None else a.astype(dtype)


def shard_framebuffer(fb: torch.Tensor, mesh: RenderMesh) \
        -> ShardedFramebuffer:
    """A copy of ``fb`` ((H, W, 4)) in row blocks over the mesh's rows;
    H must divide by them."""
    n = mesh.rows
    height = fb.shape[0]
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by the mesh's "
                         f"{n} rows")
    b = height // n
    return ShardedFramebuffer(
        [fb[i * b:(i + 1) * b].to(mesh.at(i), copy=True).contiguous()
         for i in range(n)], mesh)


# --------------------------------------------------------------------------
# the scene on a mesh
# --------------------------------------------------------------------------
def _copy_scene(scene: TorchScene, dev: torch.device) -> TorchScene:
    """``scene`` with a copy of every tensor on ``dev`` (a copy even on
    its own device); no derived tables, a write log of its own."""
    return dataclasses.replace(scene, **{
        f: getattr(scene, f).to(dev, copy=True) for f in TENSORS})


class SceneReplicas:
    """A ``TorchScene`` on each of some distinct devices (reference
    ``replicate_scene``): the scene itself on its own device, a copy on
    each other. The copies belong to the devices, not to a mesh: any mesh
    over those devices renders from them (``Renderer`` keeps them when the
    default mesh shrinks or grows with the frame's height).

    The reference gets this for free: it hands an immutable pytree to each
    call. A port scene is written in place by camera moves and live edits,
    and its kernels keep tables per scene and device (``derived``).
    ``follow`` brings the copies up to date without a readback: it copies
    the tensor fields the write log names since it last looked, drops the
    copies' derived tables as ``DERIVED_ON_EDIT`` says for each kind of
    write and copies the in-place-written ``megakernel_tables`` entries
    (``TABLE_WRITES``). Given the scene an edit put in the source's place
    (same write log), it keeps each copied tensor the two scenes share and
    copies only the new ones; given an unrelated scene, it copies it
    whole."""

    def __init__(self, scene: TorchScene, devices):
        devices = tuple(dict.fromkeys(devices))
        if scene.device != devices[0]:
            raise ValueError(f"scene is on {scene.device}, the first device "
                             f"is {devices[0]}")
        self.source = scene
        self.seen = scene.writes.version
        self._on = {dev: self._replica(scene, dev) for dev in devices}

    @property
    def devices(self) -> tuple:
        """The devices that hold the scene, the source's first."""
        return tuple(self._on)

    def _replica(self, scene: TorchScene, dev: torch.device) -> TorchScene:
        """The scene as ``dev`` holds it: itself on its own device."""
        return scene if dev == scene.device else _copy_scene(scene, dev)

    def on(self, dev: torch.device) -> TorchScene:
        """The scene on ``dev``."""
        return self._on[dev]

    def follow(self, scene: TorchScene | None = None) -> "SceneReplicas":
        """Bring every copy up to date with ``scene`` (the source as it
        stands when None)."""
        if scene is not None and scene is not self.source:
            if scene.writes is not self.source.writes:
                self.__init__(scene, self.devices)
                return self
            self._carry(scene)
        self._sync()
        return self

    def cover(self, devices) -> "SceneReplicas":
        """A copy of the source, as it stands, on each of ``devices`` that
        has none (call after ``follow``)."""
        for dev in devices:
            if dev not in self._on:
                self._on[dev] = self._replica(self.source, dev)
        return self

    def _carry(self, scene: TorchScene) -> None:
        """Copies of ``scene``, which an edit made from the source: the
        tensors it shares with the source are kept from the old copies,
        its derived tables carried where the source still holds them."""
        old = self.source
        for dev, rep in self._on.items():
            if rep is old:
                self._on[dev] = scene
                continue
            tensors = {}
            for f in TENSORS:
                t = getattr(scene, f)
                tensors[f] = getattr(rep, f) if t is getattr(old, f) \
                    else t.to(dev, copy=True)
            new = dataclasses.replace(scene, **tensors)
            new.derived.update({k: v for k, v in rep.derived.items()
                                if k in scene.derived})
            self._on[dev] = new
        self.source = scene

    def _sync(self) -> None:
        """Replay the source's writes since ``seen`` into the copies."""
        src = self.source
        changed = src.writes.since(self.seen)
        self.seen = src.writes.version
        if not changed:
            return
        mine = src.derived.get("megakernel_tables")
        for rep in self._on.values():
            if rep is src:
                continue
            for f in TENSORS:
                if f in changed:
                    getattr(rep, f).copy_(getattr(src, f), non_blocking=True)
            for kind in DERIVED_ON_EDIT:
                if kind in changed:
                    drop_derived(rep, kind)
            tables = rep.derived.get("megakernel_tables")
            for kind, entry in TABLE_WRITES.items():
                if kind not in changed or tables is None:
                    continue
                if mine is not None and mine[entry].shape \
                        == tables[entry].shape:
                    tables[entry].copy_(mine[entry], non_blocking=True)
                else:
                    del rep.derived["megakernel_tables"]
                    tables = None


def replicate_scene(scene: TorchScene, mesh: RenderMesh) -> SceneReplicas:
    """The scene on every distinct device of the mesh (``SceneReplicas``);
    ``scene`` must lie on the mesh's home device."""
    if scene.device != mesh.home:
        raise ValueError(f"scene is on {scene.device}, the mesh's home "
                         f"device is {mesh.home}")
    return SceneReplicas(scene, mesh.distinct)


def _replicas(scene, mesh: RenderMesh) -> SceneReplicas:
    if isinstance(scene, SceneReplicas):
        missing = sorted(str(d) for d in set(mesh.distinct)
                         - set(scene.devices))
        if missing:
            raise ValueError(f"the scene has no copy on {missing}")
        return scene.follow()
    return replicate_scene(scene, mesh)


def _check_sharded(fb, mesh: RenderMesh, width: int, height: int) -> None:
    if not isinstance(fb, ShardedFramebuffer) or fb.mesh.rows != mesh.rows \
            or any(b.device != mesh.at(i) for i, b in enumerate(fb.blocks)):
        raise ValueError("the framebuffer must be row-sharded over the "
                         "mesh (shard_framebuffer)")
    if tuple(fb.shape) != (height, width, 4):
        raise ValueError(f"framebuffer {tuple(fb.shape)} for a {width}x"
                         f"{height} frame")


def _mean(samples, dev: torch.device) -> torch.Tensor:
    """The images summed in order on ``dev``, divided by their count as
    ``pmean`` does (by a float32 tensor: a division by a host scalar may
    run as a product with its reciprocal)."""
    acc = None
    for s in samples:
        s = s.to(dev, non_blocking=True)
        acc = s if acc is None else acc + s
    return acc / torch.tensor(float(len(samples)), dtype=torch.float32,
                              device=dev)


def _total(segments, home: torch.device) -> torch.Tensor:
    """The segment counts summed in int64 on ``home``."""
    total = torch.zeros((), dtype=torch.int64, device=home)
    for s in segments:
        total += s.to(home, non_blocking=True)
    return total


# --------------------------------------------------------------------------
# the three layouts
# --------------------------------------------------------------------------
def render_frame_sharded(scene, framebuffer: ShardedFramebuffer,
                         frames: int, debug_scale: float = 100.0, *,
                         mesh: RenderMesh, width: int, height: int,
                         bounces: int, rays_per_pixel: int, skybox: bool,
                         antialias: bool = False, nee: bool = False,
                         normal_maps: bool = False, debug_mode: int = 0):
    """Render + accumulate one frame with the framebuffer row-sharded: the
    first device of mesh row i renders rows ``[i * block, (i + 1) *
    block)`` (``block = height / rows``) and blends them into its block.
    ``scene``: a ``TorchScene`` on the home device or its
    ``SceneReplicas``. Returns (the framebuffer, updated in place; the
    frame's segments, int64 on the home device)."""
    n = mesh.rows
    if height % n != 0:
        raise ValueError(f"height {height} not divisible by the mesh's "
                         f"{n} rows")
    _check_sharded(framebuffer, mesh, width, height)
    reps = _replicas(scene, mesh)
    block = height // n
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox,
              antialias=antialias, nee=nee, normal_maps=normal_maps,
              debug_mode=debug_mode, debug_scale=debug_scale, rows=block)
    w = blend_weight(frames)
    segments = []
    for i in range(n):
        sample, segs = render_sample(reps.on(mesh.at(i)), frames,
                                     row_start=i * block, **kw)
        blend(framebuffer.blocks[i], sample, w)
        segments.append(segs)
    return framebuffer, _total(segments, mesh.home)


def render_frame_spp_sharded(scene, framebuffer: torch.Tensor, frames: int,
                             *, mesh: RenderMesh, width: int, height: int,
                             bounces: int, rays_per_pixel: int,
                             skybox: bool, antialias: bool = False,
                             nee: bool = False, normal_maps: bool = False):
    """Accumulate one round of n samples a pixel (n = the mesh's devices):
    device i renders the whole image at RNG frame ``frames * n + i``; the
    mean of the n images, on the home device, is blended with the round's
    weight ``n / (frames * n + n)`` (``frames`` counts rounds).
    ``framebuffer``: (height, width, 4) float32 on the home device, updated
    in place. Returns (framebuffer, the round's segments)."""
    n = mesh.size
    if tuple(framebuffer.shape) != (height, width, 4) \
            or framebuffer.device != mesh.home:
        raise ValueError(f"framebuffer {tuple(framebuffer.shape)} on "
                         f"{framebuffer.device}: expected ({height}, "
                         f"{width}, 4) on {mesh.home}")
    reps = _replicas(scene, mesh)
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox,
              antialias=antialias, nee=nee, normal_maps=normal_maps)
    samples, segments = [], []
    for i, dev in enumerate(mesh.devices):
        sample, segs = render_sample(reps.on(dev), frames * n + i, **kw)
        samples.append(sample)
        segments.append(segs)
    # the reference's float32 round weight, each operation rounded
    fn = np.float32(n)
    w = fn / (np.float32(frames) * fn + fn) if frames >= 1 \
        else np.float32(1.0)
    blend(framebuffer, _mean(samples, mesh.home), w)
    return framebuffer, _total(segments, mesh.home)


def render_frame_hybrid_sharded(scene, framebuffer: ShardedFramebuffer,
                                frames: int, *, mesh: RenderMesh,
                                width: int, height: int, bounces: int,
                                rays_per_pixel: int, skybox: bool,
                                antialias: bool = False, nee: bool = False,
                                normal_maps: bool = False):
    """One accumulation round over a 2-D (rows x spp) mesh: device (i, j)
    renders row block i at RNG frame ``frames * S + j``; the S samples of
    each block are averaged on the row's first device and blended into its
    block at ``1 / (frames + 1)`` (``frames`` counts rounds). Returns
    (framebuffer, the round's segments over every device)."""
    if mesh.axes != ("rows", "spp"):
        raise ValueError(f"a 2-D rows x spp mesh, not {mesh.axes}")
    R, S = mesh.sizes
    if height % R != 0:
        raise ValueError(f"height {height} not divisible by rows={R}")
    _check_sharded(framebuffer, mesh, width, height)
    reps = _replicas(scene, mesh)
    block = height // R
    kw = dict(width=width, height=height, bounces=bounces,
              rays_per_pixel=rays_per_pixel, skybox=skybox,
              antialias=antialias, nee=nee, normal_maps=normal_maps,
              rows=block)
    samples, segments = [], []
    for i in range(R):
        for j in range(S):
            sample, segs = render_sample(reps.on(mesh.at(i, j)),
                                         frames * S + j,
                                         row_start=i * block, **kw)
            samples.append(sample)
            segments.append(segs)
    w = blend_weight(frames)
    for i in range(R):
        blend(framebuffer.blocks[i],
              _mean(samples[i * S:(i + 1) * S], mesh.at(i)), w)
    return framebuffer, _total(segments, mesh.home)


#: the mesh twin of ``engine/renderer.py:render_frame`` (reference
#: ``render_frame_mesh``): its options plus ``mesh``, its return
render_frame_mesh = render_frame_sharded


def render_frames_batched_mesh(scene, framebuffer: ShardedFramebuffer,
                               frames0: int, debug_scale: float = 100.0, *,
                               mesh: RenderMesh, n_frames: int, **kw):
    """The mesh twin of ``Renderer.render_batch``: ``n_frames`` progressive
    frames, RNG frames ``frames0 .. frames0 + n_frames - 1``, queued with no
    host synchronisation, bit-identical to ``n_frames`` calls of
    ``render_frame_mesh``. Returns (framebuffer, the batch's segments)."""
    reps = _replicas(scene, mesh)
    total = torch.zeros((), dtype=torch.int64, device=mesh.home)
    for f in range(frames0, frames0 + n_frames):
        framebuffer, segs = render_frame_sharded(
            reps, framebuffer, f, debug_scale, mesh=mesh, **kw)
        total = total + segs
    return framebuffer, total
