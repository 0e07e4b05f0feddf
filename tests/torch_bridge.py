"""Shared helpers of the port's tests (tests/test_torch_*.py): bring a scene
of the JAX package over to the PyTorch port through numpy, so both render
from identical tables."""
from __future__ import annotations

import dataclasses
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.kernels.megakernel import \
    render_persistent as _ref_render_persistent
from ray_tracer_2_tpu_torch.kernels.megakernel import render_persistent
from ray_tracer_2_tpu_torch.scene.render_scene import (
    FIELDS, STATICS, TorchScene,
)

#: the image size the render comparisons use
W, H = 32, 16
_JITS = {}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run PyTorch's CPU ops on the calling thread only. With JAX's CPU
    runtime in the same process, one of PyTorch's worker threads was seen
    to round differently now and then (a worker's share of the elements,
    up to 3e-3 relative after cancellation); the main thread never was.
    Import it into a test module to apply it there."""
    prev = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(prev)


def torch_scene(rs) -> TorchScene:
    """The port's scene for a reference ``RenderScene`` (CPU tensors)."""
    return TorchScene.from_numpy({f: np.asarray(getattr(rs, f))
                                  for f in FIELDS},
                                 {k: getattr(rs, k) for k in STATICS})


def ref_definition(port):
    """The JAX package's ``SceneDefinition`` for a port one: the same
    camera, entities, transforms and materials. A ``MeshData`` that several
    port entities share maps to one reference ``MeshData``, so instances
    that share tables in the port share them in the reference too."""
    from ray_tracer_2_tpu.math.transform import Transform
    from ray_tracer_2_tpu.scene import definition as rd
    from ray_tracer_2_tpu.scene.material import MaterialDefinition, \
        MaterialFlag
    from ray_tracer_2_tpu_torch.scene.definition import MeshFromData, \
        SphereDef

    def transform(t):
        return Transform(pos=t.pos, rot=t.rot, scale=t.scale)

    def material(m):
        fields = dataclasses.asdict(m)
        fields["flag"] = MaterialFlag(int(m.flag))
        return MaterialDefinition(**fields)

    cam = port.camera
    s = rd.SceneDefinition()
    s.set_camera(rd.CameraDescriptor(
        transform=transform(cam.transform), fov=cam.fov, aspect=cam.aspect,
        near=cam.near, far=cam.far, focus_dist=cam.focus_dist,
        defocus_strength=cam.defocus_strength,
        diverge_strength=cam.diverge_strength))
    meshes = {}
    for e in port.entities:
        p = e.primitive
        if isinstance(p, SphereDef):
            s.add_sphere(p.centre, p.radius, material(e.material))
        elif isinstance(p, MeshFromData):
            if id(p.data) not in meshes:
                meshes[id(p.data)] = rd.MeshData(
                    p.data.positions, p.data.normals, p.data.uvs,
                    p.data.indices)
            s.add_mesh(transform(e.transform),
                       rd.MeshFromData(meshes[id(p.data)], p.indices),
                       material(e.material))
        else:
            raise TypeError(f"no reference counterpart for {p!r}")
    return s


def wide_bvh_render_scene():
    """The reference's asset-free wide-BVH scene (__graft_entry__)."""
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    from __graft_entry__ import _wide_bvh_scene
    return _wide_bvh_scene()


def frac_within(a, b, tol: float = 1e-5) -> float:
    """Share of pixels whose four channels all agree within ``tol``."""
    err = np.abs(np.asarray(a) - np.asarray(b)).max(axis=-1)
    return float((err < tol).mean())


def ref_render(rs, frames, fused=True, **over):
    """JAX ``render_persistent`` at W x H (128 lanes, unroll 2; the fused
    boundary runs in the Pallas interpreter). Returns (image, segments)."""
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True,
              lanes=128, unroll=2)
    kw.update(over)
    key = (fused, tuple(sorted(kw.items())))
    if key not in _JITS:
        _JITS[key] = jax.jit(lambda s, f: _ref_render_persistent(
            s, f, fused_boundary=fused, **kw))
    img, segs = _JITS[key](rs, frames)
    return np.asarray(img), int(float(segs))


def import_probe_scripts():
    """Put the TPU probe scripts (``scripts/probe_*.py``) on ``sys.path``
    and return the ``scripts`` directory."""
    scripts = str(Path(__file__).resolve().parents[1] / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return scripts


def to_torch(a) -> torch.Tensor:
    """A JAX or numpy array as a CPU tensor of the same type (bfloat16
    through float32, which holds every bfloat16 exactly)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16)
    return torch.from_numpy(a.copy())


class BenchRecorder:
    """Stands in for a TPU probe script's ``bench`` / ``bench_varying``:
    calls ``fn`` once on its arguments, at once (the scripts' closures
    read their loop variables late), and keeps (arguments as numpy,
    output as numpy) in ``calls``. With ``keep``, only the calls whose
    index is in it run; the rest are skipped (their sizes are too large
    for the CPU)."""

    def __init__(self, keep=None):
        self.calls, self.keep, self.n = [], keep, 0

    def bench(self, fn, *args, **kw):
        i, self.n = self.n, self.n + 1
        if self.keep is None or i in self.keep:
            out = jax.tree.map(np.asarray, fn(*args))
            self.calls.append(([np.asarray(a) for a in args], out))
        return 1.0

    def bench_varying(self, fn, argiter, **kw):
        return self.bench(fn, next(argiter))


def port_render(ts, frames, **over):
    """The port's ``render_persistent`` at W x H. Returns (image, segments)."""
    kw = dict(width=W, height=H, bounces=0, rays_per_pixel=1, skybox=True)
    kw.update(over)
    img, segs = render_persistent(ts, frames, **kw)
    assert img.dtype == torch.float32 and segs.dtype == torch.int64
    return img.numpy(), int(segs)
