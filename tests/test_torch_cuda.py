"""The CUDA kernels on the card, against their plain PyTorch versions there.

The main path's kernel (``csrc/megakernel.cu``, on the wide-BVH scene, on
room2 and on four shared instances), the small-scene kernel (``csrc/spheres.cu``) and the brute-force
kernel (``csrc/brute.cu``). These tests need a CUDA card (the kernels have
no CPU mode) and skip without one. The file imports neither JAX nor the JAX package, so it also runs on
the GPU machine, which has no JAX; there, skip the JAX-importing conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu_torch.config import RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.brute import (
    CUDA_BRUTE, INF, brute_force_intersect, brute_force_intersect_plain,
)
from ray_tracer_2_tpu_torch.kernels.megakernel import (
    CUDA_MEGAKERNEL, render_persistent, render_plain,
)
from ray_tracer_2_tpu_torch.kernels.spheres import (
    CUDA_SPHERES, render_spheres_plain,
)
from ray_tracer_2_tpu_torch.math.transform import Transform
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.definition import (
    MeshFromData, SceneDefinition,
)
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture(scope="module")
def scene():
    _need_card()
    return instantiate_scene(scenes.wide_bvh_scene()).to("cuda")


@pytest.fixture(scope="module")
def small_scenes():
    _need_card()
    return {name: instantiate_scene(getattr(scenes, name)()).to("cuda")
            for name in ("random_balls", "room")}


def _frac_within(a, b, tol=1e-5):
    return float(((a - b).abs().amax(dim=-1) < tol).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [0, 5])
def test_kernel_matches_plain(scene, bounces):
    """Kernel and plain version share op order and the CUDA libm, so at
    every bounce count segments are exact and >= 99.9% of pixels agree
    within 1e-5 (the looser classes are for the CPU tests against JAX)."""
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    ki, ks = CUDA_MEGAKERNEL(scene, 1, **kw)
    pi, ps = render_plain(scene, 1, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ki).all())
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert int(ks) == int(ps)
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
def test_cuda_scenes_go_through_the_kernel(scene):
    before = CUDA_MEGAKERNEL.launches
    img, segs = render_persistent(scene, 0, width=64, height=36, bounces=2,
                                  rays_per_pixel=2, skybox=True,
                                  antialias=True, row_start=8, rows=20)
    torch.cuda.synchronize()
    assert CUDA_MEGAKERNEL.launches == before + 1
    assert tuple(img.shape) == (20, 64, 4) and img.is_cuda
    full, _ = render_plain(scene, 0, width=64, height=36, bounces=2,
                           rays_per_pixel=2, skybox=True, antialias=True)
    assert _frac_within(img, full[8:28]) >= 0.999
    assert int(segs) >= 2 * 20 * 64


@pytest.mark.cuda
def test_cuda_scene_on_cpu_renderer_raises(scene):
    renderer = Renderer(device="cpu")
    with pytest.raises(ValueError, match="scene.to"):
        renderer.render(scene, RenderParams(width=16, height=8))
    assert renderer.framebuffer is None
    Renderer(device="cuda").render(scene, RenderParams(width=16, height=8))


def test_wrapper_rejects_cpu_tensors():
    """Runs anywhere: the wrapper raises on CPU tensors instead of falling
    back to the plain version."""
    cpu = instantiate_scene(scenes.wide_bvh_scene())
    with pytest.raises(ValueError, match="CUDA tensors"):
        CUDA_MEGAKERNEL(cpu, 0, width=8, height=8, bounces=0,
                        rays_per_pixel=1, skybox=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_balls", "room"])
@pytest.mark.parametrize("bounces", [0, 5])
def test_spheres_kernel_matches_plain(small_scenes, name, bounces):
    """The small-scene kernel against its plain version, in the same class
    as the main path's: segments exact, >= 99.9% of pixels within 1e-5."""
    scene = small_scenes[name]
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    ki, ks = CUDA_SPHERES(scene, 1, **kw)
    pi, ps = render_spheres_plain(scene, 1, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ki).all())
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert int(ks) == int(ps)
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
def test_cuda_small_scene_goes_through_its_kernel(small_scenes):
    """Renderer.render on a CUDA sphere scene launches the small-scene
    kernel once per frame and the main path's kernel never."""
    renderer = Renderer(device="cuda")
    before = (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches)
    for f in range(2):
        renderer.render(small_scenes["random_balls"],
                        RenderParams(width=64, height=36, bounces=2,
                                     frames=f))
    torch.cuda.synchronize()
    assert (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches) == \
        (before[0] + 2, before[1])
    assert renderer.framebuffer.is_cuda
    assert bool(torch.isfinite(renderer.framebuffer).all())


def test_spheres_wrapper_rejects_cpu_tensors():
    """Runs anywhere: the small-scene wrapper raises on CPU tensors instead
    of falling back to the plain version."""
    cpu = instantiate_scene(scenes.metal())
    with pytest.raises(ValueError, match="CUDA tensors"):
        CUDA_SPHERES(cpu, 0, width=8, height=8, bounces=0, rays_per_pixel=1,
                     skybox=True)


@pytest.fixture(scope="module")
def room2():
    _need_card()
    return instantiate_scene(scenes.room2_scene(12, 12)).to("cuda")


def _megakernel_matches_plain(scene, bounces):
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    ki, ks = CUDA_MEGAKERNEL(scene, 1, **kw)
    pi, ps = render_plain(scene, 1, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ki).all())
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert int(ks) == int(ps)
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [0, 5])
def test_room2_kernel_matches_plain(room2, bounces):
    """Two instances sharing one table, a brute-force group and glass:
    segments exact, >= 99.9% of pixels within 1e-5."""
    _megakernel_matches_plain(room2, bounces)


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [0, 5])
def test_instances_kernel_matches_plain(bounces):
    """Four instances of two shared tables (BVH and brute force) under
    their own transforms and deltas, on 38% of the primary rays: segments
    exact, >= 99.9% of pixels within 1e-5."""
    _need_card()
    _megakernel_matches_plain(
        instantiate_scene(scenes.instances_scene()).to("cuda"), bounces)


@pytest.mark.cuda
def test_room2_goes_through_the_brute_prepass(room2):
    """Renderer.render on room2 launches the megakernel once per frame,
    and the kernel's own counts show the brute-force prepass ran once per
    segment in each launch; the other kernels are never launched."""
    CUDA_MEGAKERNEL.reset_counts()
    before = (CUDA_BRUTE.launches, CUDA_SPHERES.launches)
    renderer = Renderer(device="cuda")
    segs = 0
    for f in range(2):
        renderer.render(room2, RenderParams(width=64, height=36, bounces=2,
                                            frames=f))
        segs += int(renderer.last_segments)
    assert CUDA_MEGAKERNEL.launches == 2
    assert CUDA_MEGAKERNEL.prepass_counts() == (segs, 2)
    assert (CUDA_BRUTE.launches, CUDA_SPHERES.launches) == before
    assert bool(torch.isfinite(renderer.framebuffer).all())


@pytest.mark.cuda
def test_main_path_runs_no_prepass(scene):
    """The single-instance scene takes the kernel's form without the
    brute-force prepass: its device count stays 0."""
    CUDA_MEGAKERNEL.reset_counts()
    render_persistent(scene, 0, width=64, height=36, bounces=2,
                      rays_per_pixel=1, skybox=True)
    assert CUDA_MEGAKERNEL.prepass_counts() == (0, 0)
    assert CUDA_MEGAKERNEL.launches == 1


@pytest.mark.cuda
def test_brute_kernel_matches_plain():
    """256 triangles of mixed cull (a glass soup inside a diffuse one)
    against 4096 seeded rays: tri and mat exact, dst/u/v/det within 1e-5
    on >= 99.9% of the rays."""
    _need_card()
    s = SceneDefinition()
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(8, 8, 1.0)),
               MaterialDefinition.new())
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(8, 8, 0.5)),
               MaterialDefinition.new().glass(1.5))
    scene = instantiate_scene(s).to("cuda")
    _, tri_off, count = scene.inst_spans[0]
    rng = np.random.default_rng(0)
    o = rng.uniform(-1.5, 1.5, (4096, 3)).astype(np.float32)
    d = rng.normal(size=(4096, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o, d = torch.from_numpy(o).cuda(), torch.from_numpy(d).cuda()
    before = CUDA_BRUTE.launches
    k = brute_force_intersect(scene, o, d, tri_off, count)
    p = brute_force_intersect_plain(scene, o, d, tri_off, count)
    torch.cuda.synchronize()
    assert CUDA_BRUTE.launches == before + 1
    assert bool((k["tri"] == p["tri"]).all())
    assert bool((k["mat"] == p["mat"]).all())
    assert int((p["tri"] >= 0).sum()) > 400
    assert bool((k["dst"][p["tri"] < 0] == INF).all())
    err = torch.stack([(k[f] - p[f]).abs()
                       for f in ("dst", "u", "v", "det")]).amax(dim=0)
    assert float((err < 1e-5).float().mean()) >= 0.999


# Edges of the persistent kernels' pixel cursor: fewer pixels than a warp,
# a pixel total that is not a multiple of 32, a row window, several samples
# with antialias, no bounce.
_EDGES = [dict(width=5, height=3, bounces=5),
          dict(width=37, height=21, bounces=3),
          dict(width=64, height=36, bounces=2, row_start=11, rows=13),
          dict(width=45, height=26, bounces=2, rays_per_pixel=3,
               antialias=True),
          dict(width=40, height=22, bounces=0)]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_EDGES)))
def test_persistent_megakernel_edges(scene, case):
    """The megakernel against its plain version at the cursor's edges:
    segments exact, >= 99.9% of pixels within 1e-5, row, leaf and
    child-box visits equal, and one active lane per traced segment."""
    kw = dict(dict(rays_per_pixel=1, skybox=True), **_EDGES[case])
    CUDA_MEGAKERNEL.reset_counts()
    ki, ks = CUDA_MEGAKERNEL(scene, 1, **kw)
    kc = CUDA_MEGAKERNEL.read_counts()
    pc = {}
    pi, ps = render_plain(scene, 1, counts=pc, **kw)
    assert bool(torch.isfinite(ki).all())
    assert int(ks) == int(ps) == kc["active_lanes"]
    assert [kc[k] for k in ("rows", "leaves", "boxes")] == \
        [pc[k] for k in ("rows", "leaves", "boxes")]
    assert 0 < kc["turns"] and kc["active_lanes"] <= 32 * kc["turns"]
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(len(_EDGES)))
def test_persistent_spheres_edges(small_scenes, case):
    """The small-scene kernel against its plain version at the cursor's
    edges (rpp 3 without antialias, which that path does not take):
    segments exact, >= 99.9% of pixels within 1e-5, one active lane per
    traced segment."""
    kw = dict(dict(rays_per_pixel=1, skybox=True), **_EDGES[case])
    kw.pop("antialias", None)
    scene = small_scenes["room"]
    CUDA_SPHERES.reset_counts()
    ki, ks = CUDA_SPHERES(scene, 1, **kw)
    kc = CUDA_SPHERES.read_counts()
    pi, ps = render_spheres_plain(scene, 1, **kw)
    assert bool(torch.isfinite(ki).all())
    assert int(ks) == int(ps) == kc["active_lanes"]
    assert 0 < kc["turns"] and kc["active_lanes"] <= 32 * kc["turns"]
    assert _frac_within(ki, pi) >= 0.999


def test_brute_wrapper_rejects_cpu_tensors():
    """Runs anywhere: the brute-force wrapper raises on CPU tensors
    instead of falling back to the plain version."""
    with pytest.raises(ValueError, match="CUDA tensors"):
        CUDA_BRUTE(torch.zeros((4, 8)), torch.zeros((2, 16)), 2)
