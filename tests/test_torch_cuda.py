"""The CUDA kernels on the card, against their plain PyTorch versions there.

The main path's kernel (``csrc/megakernel.cu``, on the wide-BVH scene, on
room2 and on four shared instances, with next-event estimation, and its
textured forms on textured scenes and normal maps), the small-scene kernel (``csrc/spheres.cu``), the brute-force
kernel (``csrc/brute.cu``), the debug kernel (``csrc/debug.cu``, every mode),
the probe kernels (``csrc/probe_*.cu``), and on the card ``render_batch``,
``Engine``'s camera move, scenes after live edits (each kernel frame
bit-equal to its plain version) and the viewer's PNG frames. These tests need a CUDA card (the kernels have
no CPU mode) and skip without one. The file imports neither JAX nor the JAX package, so it also runs on
the GPU machine, which has no JAX; there, skip the JAX-importing conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import dataclasses

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
    Renderer(device="cuda", mesh=None).render(
        scene, RenderParams(width=16, height=8))


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
    renderer = Renderer(device="cuda", mesh=None)
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
    renderer = Renderer(device="cuda", mesh=None)
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


def _brute_case_names():
    from ray_tracer_2_tpu_torch.kernels.brute_cases import edge_cases
    return [c.name for c in edge_cases()]


@pytest.mark.cuda
@pytest.mark.parametrize("name", _brute_case_names())
def test_brute_kernel_edge_cases(name):
    """The list the plain version is pinned on against JAX and numpy
    (tests/test_torch_brute.py), on the card: kernel against plain version,
    ``tri`` and ``mat`` exact, ``dst, u, v, det`` within 1e-5 on every
    ray."""
    _need_card()
    from ray_tracer_2_tpu_torch.kernels.brute_cases import (
        edge_cases, table_scene,
    )
    case = {c.name: c for c in edge_cases()}[name]
    ns = table_scene(case, "cuda")
    o = torch.from_numpy(case.origin).cuda()
    d = torch.from_numpy(case.direction).cuda()
    k = brute_force_intersect(ns, o, d, 0, case.count)
    p = brute_force_intersect_plain(ns, o, d, 0, case.count)
    assert int((p["tri"] >= 0).sum()) >= case.min_hits
    assert bool((k["tri"] == p["tri"]).all())
    assert bool((k["mat"] == p["mat"]).all())
    for f in ("dst", "u", "v", "det"):
        assert float((k[f] - p[f]).abs().max()) < 1e-5, f


@pytest.mark.cuda
def test_brute_kernel_partial_block_and_chunks():
    """A ray count that fills no block (1000) against a table of three
    staged chunks (600): ``tri`` and ``mat`` exact, ``dst`` within 1e-5."""
    _need_card()
    from ray_tracer_2_tpu_torch.kernels.brute import pack_brute_table
    from ray_tracer_2_tpu_torch.kernels.brute_cases import (
        edge_cases, table_scene,
    )
    case = {c.name: c for c in edge_cases()}["soup_600"]
    ns = table_scene(case, "cuda")
    table = pack_brute_table(ns, 0, 600)
    rng = np.random.default_rng(3)
    rays = np.zeros((1000, 8), np.float32)
    rays[:, 0:3] = rng.uniform(-1.5, 1.5, (1000, 3))
    d = rng.normal(size=(1000, 3))
    rays[:, 3:6] = d / np.linalg.norm(d, axis=1, keepdims=True)
    rays = torch.from_numpy(rays).cuda()
    out = CUDA_BRUTE(rays, table, 600)
    p = brute_force_intersect_plain(ns, rays[:, 0:3].contiguous(),
                                    rays[:, 3:6].contiguous(), 0, 600)
    assert int((p["tri"] >= 0).sum()) > 100
    assert bool((out[:, 5].long() == p["tri"]).all())
    assert bool((out[:, 4].long() == p["mat"]).all())
    assert float((out[:, 0] - p["dst"]).abs()[p["tri"] >= 0].max()) < 1e-5


# ---------------------------------------------------- sphere-heavy scenes --
def _with_spheres(definition, n, seed):
    """``definition`` plus ``n`` small spheres from ``seed``, scattered
    through the view volume before the camera of ``random_balls``."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        centre = rng.uniform([-4.0, 0.1, -4.0], [4.0, 2.5, 4.0])
        mat = MaterialDefinition.new().with_color(
            [*rng.uniform(0.2, 0.9, 3), 1.0])
        if rng.random() < 0.2:
            mat = mat.specular_([1.0] * 4, 0.3)
        definition.add_sphere(centre.astype(np.float32),
                              float(rng.uniform(0.05, 0.25)), mat)
    return definition


def _balls(n, seed=0):
    """A ground sphere, a glass one and ``n - 2`` small ones under
    ``random_balls``' camera."""
    s = SceneDefinition()
    s.set_camera(scenes.random_balls().camera)
    s.add_sphere([0.0, -1000.0, 0.0], 1000.0,
                 MaterialDefinition.new().with_color([0.5, 0.5, 0.5, 1.0]))
    s.add_sphere([0.0, 1.0, 0.0], 1.0, MaterialDefinition.new().glass(1.5))
    return _with_spheres(s, n - 2, seed)


def _over_budget(extra_spheres):
    """Two 256-triangle groups (33,024 bytes of staged tables) plus
    ``extra_spheres`` spheres at 20 bytes each: 192 fill the 36,864-byte
    budget, 193 pass it."""
    return _with_spheres(scenes.groups_scene(2), extra_spheres, 1)


# name -> (definition, sphere_bvh, antialias, bounces, spheres_mode, staged)
_SPHERE_CELLS = {
    "random_balls_aa_b0": (scenes.random_balls, None, True, 0, 1, True),
    "random_balls_aa_b5": (scenes.random_balls, None, True, 5, 1, True),
    "random_balls_bvh_b0": (scenes.random_balls, True, True, 0, 2, True),
    "random_balls_bvh_b5": (scenes.random_balls, True, True, 5, 2, True),
    "random_balls_half24_b5": (lambda: scenes.random_balls(half=24), None,
                               False, 5, 2, True),
    "groups5_b5": (lambda: scenes.groups_scene(5), None, False, 5, 0, False),
    "balls33": (lambda: _balls(33), None, False, 3, 0, True),
    "balls63": (lambda: _balls(63), None, False, 3, 0, True),
    "balls64": (lambda: _balls(64), None, False, 3, 1, True),
    "balls65": (lambda: _balls(65), None, True, 3, 1, True),
    "balls1843": (lambda: _balls(1843), None, False, 3, 1, True),
    "balls2047": (lambda: _balls(2047), None, False, 3, 1, False),
    "balls9_bvh": (lambda: _balls(9), True, False, 3, 2, True),
    "balls100_mesh_bvh": (lambda: _with_spheres(scenes.wide_bvh_scene(), 99,
                                                 2), True, False, 3, 2, True),
    "balls100_mesh": (lambda: _with_spheres(scenes.wide_bvh_scene(), 99, 2),
                      None, False, 3, 1, True),
    "under_budget": (lambda: _over_budget(192), None, False, 3, 1, True),
    "over_budget": (lambda: _over_budget(193), None, False, 3, 1, False),
    "over_budget_bvh": (lambda: _with_spheres(scenes.groups_scene(5), 40, 3),
                        True, False, 3, 2, False),
}


def test_sphere_cells_pick_their_forms():
    """Runs anywhere: each cell below is the kernel form it is named for
    (``kernel_tables``: how spheres are tested, staged or global tables)."""
    from ray_tracer_2_tpu_torch.kernels.megakernel import kernel_tables
    for name, (make, bvh, _aa, _b, mode, staged) in _SPHERE_CELLS.items():
        if name in ("balls1843", "balls2047", "random_balls_half24_b5"):
            continue            # seconds of host BVH and table building
        tab = kernel_tables(instantiate_scene(make(), sphere_bvh=bvh))
        assert (tab["spheres_mode"], tab["staged"]) == (mode, staged), name
        assert tab["general"] and tab["glass"], name


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_SPHERE_CELLS))
def test_sphere_cells_match_plain(name):
    """The megakernel on sphere-heavy scenes against its plain version at
    128x72: the dense fast loop (485 spheres; both sides of 64; 1,843, the
    most that is staged, and 2,047, read from global memory), the
    sphere BVH forced, by its size, at its smallest (9 spheres: a root and
    two leaves) and after a mesh instance, and tables in global memory
    (five groups; one sphere past the budget; with the sphere BVH).
    Segments exact, >= 99.9% of pixels within 1e-5, row, leaf and box visits
    equal, one active lane per segment."""
    _need_card()
    from ray_tracer_2_tpu_torch.kernels.megakernel import kernel_tables
    make, bvh, antialias, bounces, mode, staged = _SPHERE_CELLS[name]
    scene = instantiate_scene(make(), sphere_bvh=bvh).to("cuda")
    tab = kernel_tables(scene)
    assert (tab["spheres_mode"], tab["staged"]) == (mode, staged)
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True, antialias=antialias)
    CUDA_MEGAKERNEL.reset_counts()
    ki, ks = CUDA_MEGAKERNEL(scene, 1, **kw)
    kc = CUDA_MEGAKERNEL.read_counts()
    pc = {}
    pi, ps = render_plain(scene, 1, counts=pc, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ki).all())
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert int(ks) == int(ps) == kc["active_lanes"]
    assert [kc[k] for k in ("rows", "leaves", "boxes")] == \
        [pc[k] for k in ("rows", "leaves", "boxes")]
    assert (kc["rows"] > 0) == (mode == 2 or name.startswith("balls100"))
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1500, 2047])
def test_spheres_kernel_takes_its_stated_capacity(n):
    """The small-scene kernel at 1,500 spheres and at its stated capacity
    of 2,047 (41 KB of staged tables): segments exact, >= 99.9% of pixels
    within 1e-5."""
    _need_card()
    scene = instantiate_scene(_balls(n)).to("cuda")
    kw = dict(width=128, height=72, bounces=3, rays_per_pixel=1, skybox=True)
    ki, ks = CUDA_SPHERES(scene, 1, **kw)
    pi, ps = render_spheres_plain(scene, 1, **kw)
    torch.cuda.synchronize()
    assert int(ks) == int(ps)
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
def test_spheres_kernel_at_its_triangle_cap():
    """The small-scene kernel on a 64-triangle mesh, the most it takes
    (``MAX_TRIS``), renders like its plain version."""
    _need_card()
    from ray_tracer_2_tpu_torch.kernels import spheres
    scene = instantiate_scene(scenes.wide_bvh_scene(lat=4, lon=8)).to("cuda")
    assert spheres.tri_count(scene) == spheres.MAX_TRIS
    kw = dict(width=128, height=72, bounces=3, rays_per_pixel=1, skybox=True)
    ki, ks = CUDA_SPHERES(scene, 1, **kw)
    pi, ps = render_spheres_plain(scene, 1, **kw)
    torch.cuda.synchronize()
    assert int(ks) == int(ps)
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
def test_staged_and_global_tables_render_alike(monkeypatch):
    """One scene through the staged form and, with the budget set to
    nothing, through the form that reads global memory: the same image bit
    for bit (the host's staged rows are the kernel's), the same segments
    and visits."""
    _need_card()
    from ray_tracer_2_tpu_torch.kernels import megakernel
    kw = dict(width=128, height=72, bounces=4, rays_per_pixel=1, skybox=True)
    out = []
    for budget in (megakernel.SMEM_BYTES, 0):
        monkeypatch.setattr(megakernel, "SMEM_BYTES", budget)
        scene = instantiate_scene(scenes.instances_scene()).to("cuda")
        assert megakernel.kernel_tables(scene)["staged"] == (budget > 0)
        CUDA_MEGAKERNEL.reset_counts()
        img, segs = CUDA_MEGAKERNEL(scene, 1, **kw)
        c = CUDA_MEGAKERNEL.read_counts()
        out.append((img, int(segs), [c[k] for k in ("rows", "leaves",
                                                    "boxes", "brute_calls")]))
    assert torch.equal(out[0][0], out[1][0])
    assert out[0][1:] == out[1][1:]


@pytest.mark.cuda
def test_sphere_scenes_route_to_the_megakernel():
    """``random_balls`` with antialias, and any scene instantiated with a
    sphere BVH, render through the megakernel, one launch a frame, never
    through the small-scene kernel."""
    _need_card()
    renderer = Renderer(device="cuda", mesh=None)
    plain = instantiate_scene(scenes.random_balls()).to("cuda")
    bvh = instantiate_scene(scenes.random_balls(), sphere_bvh=True).to("cuda")
    before = (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches)
    for scene, aa in ((plain, True), (bvh, False), (bvh, True)):
        renderer.render(scene, RenderParams(width=64, height=36, bounces=2,
                                            antialias=aa))
    torch.cuda.synchronize()
    assert (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches) == \
        (before[0], before[1] + 3)
    assert bool(torch.isfinite(renderer.framebuffer).all())


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


# ------------------------------------------------------------- the probes --
# Every probe that launches a kernel of probes/ (csrc/probe_*.cu), by the
# name the entry point knows it.
_KERNEL_PROBES = ["launch", "trav", "sched", "leaf", "packet", "pallas_hello",
                  "pallas_onehot_loop", "pallas_lane_gather",
                  "pallas_sublane_gather", "pallas_dyn_dma",
                  "lane_gather_chain", "sublane_gather_samey",
                  "lut1024_chain", "lut_row_fetch", "scalar_treelet_select",
                  "mxu_leaf_dense", "big_body_compile"]


def test_kernel_probe_list_is_complete():
    """Runs anywhere: the list above is the entry point's kernel probes."""
    from ray_tracer_2_tpu_torch.probes import load_all
    assert load_all().kernel_probes() == _KERNEL_PROBES


@pytest.mark.cuda
@pytest.mark.parametrize("name", _KERNEL_PROBES)
def test_probe_kernel_matches_plain(name):
    """Each probe kernel at the first of its script's sizes, through the
    entry point's runner: every output (the probe's, the final index, the
    checksum) bit-equal to the plain version on the card."""
    _need_card()
    from ray_tracer_2_tpu_torch.probes import load_all
    common = load_all()
    dev = torch.device("cuda", 0)
    ctx = common.Ctx(device=dev, smoke=True, card=common.card_name(dev))
    assert common.run(ctx, [name])
    assert ctx.records
    for r in ctx.records:
        if r["gate"] is not None:   # mxu_leaf_dense on the tensor cores
            assert r["gate"]["ok"] is True and r["form"] == "mma"
        else:
            assert r["plain_equal"] is True and r["max_abs_err"] == 0.0
    if name == "mxu_leaf_dense":    # three forms at both gated sizes
        assert [(r["form"], r["T"]) for r in ctx.records] == [
            (f, T) for f in ("simt", "simt", "mma") for T in (128, 512)]


def _probe_edge_cases():
    """Sizes off the scripts' grid: lanes that do not fill a block, tables
    of other heights, several packet copies."""
    from ray_tracer_2_tpu_torch.probes import lut, packet, r2, trav
    rng = np.random.default_rng(21)

    def t(a, dtype=None):
        x = torch.from_numpy(np.ascontiguousarray(a))
        return x if dtype is None else x.to(dtype)

    R, T, B = 16, 7, 37
    tabs = t(rng.integers(0, R, (T * R, 128)).astype(np.float32),
             torch.bfloat16)
    iv, off = (t(rng.random((B, 128)).astype(np.float32)) for _ in "ab")
    idx0 = t(rng.integers(0, R, (B, 1)).astype(np.int32))
    tid0 = t(rng.integers(0, T, (B, 1)).astype(np.int32))
    nodes = rng.random((50, 128)).astype(np.float32)
    nodes[:, 12:14] = rng.integers(0, 150, (50, 2))
    blk = t(rng.integers(0, 1024, (8, 128)).astype(np.int32))
    return [
        (trav.trav, (tabs, iv, off, idx0, tid0), dict(R=R, K=50)),
        (trav.trav, (tabs, iv, off, idx0, tid0), dict(R=R, K=50,
                                                      staged=False)),
        (trav.trav, (tabs, iv, off, idx0, tid0), dict(R=R, K=50,
                                                      sched=True)),
        (trav.leaf, (t(rng.random((64, 128)).astype(np.float32),
                       torch.bfloat16),
                     t(np.zeros((64, 128), np.float32), torch.bfloat16), iv,
                     t(rng.integers(0, 64, (B, 1)).astype(np.int32))),
         dict(K=30)),
        (packet.packet, (t(nodes), t(rng.random((33, 128)).astype(np.float32)),
                         t(rng.random((33, 128)).astype(np.float32) - 0.5)),
         dict(K=200, copies=3)),
        (r2.onehot_loop, (t(rng.integers(0, 40, (40, 128))
                            .astype(np.float32), torch.bfloat16),
                          t(rng.integers(0, 40, (45, 1)).astype(np.int32))),
         dict(steps=20)),
        (r2.lane_gather, (t(rng.integers(0, 128, (100, 128))
                            .astype(np.float32)),
                          t(rng.integers(0, 128, (100, 1)).astype(np.int32))),
         dict(steps=20)),
        (lut.lane_gather_chain, (t(rng.integers(0, 128, (16, 128))
                                   .astype(np.float32)),
                                 t(rng.integers(0, 128, (16, 128))
                                   .astype(np.int32))), dict(steps=20)),
        (lut.lut_row_fetch, (t(rng.integers(0, 1024, (24, 128))
                               .astype(np.float32)), blk), dict(steps=9)),
        (lut.big_body, (t(rng.integers(0, 1024, (56, 128))
                          .astype(np.float32)), blk), dict(steps=9)),
        (lut.mxu_leaf_dense, (t(rng.random((37, 16)).astype(np.float32)),
                              t(rng.random((16, 40)).astype(np.float32))),
         dict(steps=7)),
        (lut.mxu_leaf_dense, (t(rng.random((37, 16)).astype(np.float32)),
                              t(rng.random((16, 41)).astype(np.float32))),
         dict(steps=7)),
        (lut.mxu_leaf_dense, (t(rng.random((9, 16)).astype(np.float32)),
                              t(rng.random((16, 600)).astype(np.float32))),
         dict(steps=5)),
        (lut.mxu_leaf_dense, (t(rng.random((37, 16)).astype(np.float32),
                                torch.bfloat16),
                              t(rng.random((16, 45)).astype(np.float32),
                                torch.bfloat16)), dict(steps=7)),
    ]


@pytest.mark.cuda
@pytest.mark.parametrize("case", range(14))
def test_probe_kernel_edges(case):
    """Probe kernels against their plain versions off the scripts' sizes:
    every output bit-equal."""
    _need_card()
    from ray_tracer_2_tpu_torch.probes.common import compare
    fn, args, kw = _probe_edge_cases()[case]
    got = fn(*(a.cuda() for a in args), **kw)
    want = fn(*args, **kw)
    assert compare(tuple(g.cpu() for g in got) if isinstance(got, tuple)
                   else got.cpu(), want) == (True, 0.0)


def test_probe_wrappers_reject_cpu_tensors():
    """Runs anywhere: a probe kernel's wrapper raises on CPU tensors
    instead of running the plain version."""
    from ray_tracer_2_tpu_torch.probes import load_all
    for wrapper, _ in load_all().KERNELS.values():
        with pytest.raises(ValueError, match="CUDA tensors"):
            wrapper.launch(torch.zeros(4), 4, torch.zeros(4))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T", [(37, 40), (16, 16), (100, 136), (64, 512),
                                 (20, 264)])
def test_mxu_leaf_dense_tensor_core_form_edges(B, T):
    """The tensor-core form off the script's sizes (a ray tile that is not
    full, no column tile besides the chain's, a last warp with fewer
    column tiles than it holds, both tile widths) inside its gate against
    the plain version."""
    _need_card()
    from ray_tracer_2_tpu_torch.probes import lut
    rng = np.random.default_rng(22)
    rays = torch.from_numpy(rng.random((B, 16)).astype(np.float32)) \
        .to(torch.bfloat16)
    tris = torch.from_numpy(rng.random((16, T)).astype(np.float32)) \
        .to(torch.bfloat16)
    got = lut.mxu_leaf_dense(rays.cuda(), tris.cuda(), steps=12, form="mma")
    want = lut.mxu_leaf_dense(rays, tris, steps=12, form="mma")
    g = lut.mma_gate(tuple(x.cpu() for x in got), want)
    assert g["ok"] and g["out_finite_share"] == 1.0, g
    with pytest.raises(ValueError, match="multiple of 8"):
        lut.mxu_leaf_dense(rays.cuda(), tris[:, :T - 1].contiguous().cuda(),
                           form="mma")


# ---------------------------------------------------- next-event estimation --
def _lit_wide_bvh():
    """``wide_bvh_scene`` under a small spherical sun: one wide-BVH instance
    (the main path's kernel form without NEE) and a sphere light."""
    s = scenes.wide_bvh_scene()
    s.add_sphere([2.0, 4.0, 2.0], 0.5,
                 MaterialDefinition.new().emissive([1.0] * 4, 20.0))
    return s


def _sunlit(definition):
    """``definition`` under ``sunlit_balls``' sun."""
    sun = scenes.sunlit_balls().entities[-1]
    definition.add_sphere(sun.primitive.centre, sun.primitive.radius,
                          sun.material)
    return definition


# name -> (definition, sphere_bvh, tables in global memory, forced shadow
# segments, NEE mode, spheres_mode, staged)
_NEE_CELLS = {
    "room": (scenes.room, None, False, False, 1, 0, True),
    "room_segments": (scenes.room, None, False, True, 2, 0, True),
    "room_global": (scenes.room, None, True, False, 1, 0, False),
    "balls": (scenes.balls, None, False, False, 1, 0, True),
    "room2": (lambda: scenes.room2_scene(12, 12), None, False, False, 2, 0,
              True),
    "room2_global": (lambda: scenes.room2_scene(12, 12), None, True, False,
                     2, 0, False),
    "lit_wide_bvh": (_lit_wide_bvh, None, False, False, 2, 0, True),
    "sunlit_fast": (scenes.sunlit_balls, None, False, False, 1, 1, True),
    "sunlit_fast_segments": (scenes.sunlit_balls, None, False, True, 2, 1,
                             True),
    "sunlit_fast_global": (scenes.sunlit_balls, None, True, False, 1, 1,
                           False),
    "sunlit_bvh": (scenes.sunlit_balls, True, False, False, 2, 2, True),
    "groups_sunlit_bvh": (lambda: _sunlit(_with_spheres(
        scenes.groups_scene(5), 40, 3)), True, False, False, 2, 2, False),
}


def test_nee_cells_pick_their_forms():
    """Runs anywhere: each NEE cell is the mode and kernel form it is named
    for."""
    for name in _NEE_CELLS:
        _nee_cell(name, "cpu")


def _nee_cell(name, device="cuda"):
    from ray_tracer_2_tpu_torch.kernels.megakernel import kernel_tables, \
        nee_mode
    make, bvh, in_global, segments, mode, sph, staged = _NEE_CELLS[name]
    scene = instantiate_scene(make(), sphere_bvh=bvh).to(device)
    tab = kernel_tables(scene, budget=0 if in_global else None)
    assert (nee_mode(scene, True, segments), tab["spheres_mode"],
            tab["staged"]) == (mode, sph, staged), name
    return scene, segments


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [1, 5])
@pytest.mark.parametrize("name", list(_NEE_CELLS))
def test_nee_forms_match_plain(name, bounces):
    """Every NEE form against ``render_plain(nee=True)`` at 128x72: the
    dense exact loop staged and from global memory, the fast loop, the
    sphere BVH (staged, and from global memory past five brute-force
    groups), one wide-BVH instance, mode 1 and mode 2 (by the scene and
    forced). Bit-equal images, segments exact (shadow segments included),
    row, leaf and box visits equal, one launch of an NEE form."""
    _need_card()
    scene, segments = _nee_cell(name)
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True, nee=True, nee_segments=segments)
    CUDA_MEGAKERNEL.reset_counts()
    ki, ks = CUDA_MEGAKERNEL(scene, 1, **kw)
    kc = CUDA_MEGAKERNEL.read_counts()
    pc = {}
    pi, ps = render_plain(scene, 1, counts=pc, **kw)
    torch.cuda.synchronize()
    assert CUDA_MEGAKERNEL.nee_launches == CUDA_MEGAKERNEL.launches == 1
    assert int(ks) == int(ps) == kc["active_lanes"]
    assert [kc[k] for k in ("rows", "leaves", "boxes", "shadow_rays")] == \
        [pc[k] for k in ("rows", "leaves", "boxes", "shadow_rays")]
    assert (pc["shadow_rays"] > 0) == (bounces > 0)
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert torch.equal(ki, pi)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["room", "sunlit_fast"])
def test_nee_segments_render_the_inline_image(name):
    """The kernel in mode 1 and forced into mode 2 renders one image; mode
    2 traces more segments (one per shadow ray), mode 1 more brute-force
    calls than segments where the scene has groups."""
    _need_card()
    scene, _ = _nee_cell(name)
    kw = dict(width=128, height=72, bounces=5, rays_per_pixel=1,
              skybox=True, nee=True)
    a, sa = CUDA_MEGAKERNEL(scene, 1, **kw)
    b, sb = CUDA_MEGAKERNEL(scene, 1, nee_segments=True, **kw)
    torch.cuda.synchronize()
    assert torch.equal(a, b) and int(sb) > int(sa)


@pytest.mark.cuda
def test_nee_frames_go_through_the_megakernel():
    """``Renderer.render`` with ``nee`` on ``room`` (a small scene) and on
    room2 launches the megakernel's NEE forms, one a frame, never the
    small-scene kernel; on a scene without lights the ordinary form."""
    _need_card()
    renderer = Renderer(device="cuda", mesh=None)
    CUDA_MEGAKERNEL.reset_counts()
    before = CUDA_SPHERES.launches
    for definition in (scenes.room(), scenes.room2_scene(12, 12),
                       scenes.metal()):
        scene = instantiate_scene(definition).to("cuda")
        renderer.render(scene, RenderParams(width=64, height=36, bounces=3,
                                            nee=True))
    torch.cuda.synchronize()
    assert (CUDA_MEGAKERNEL.launches, CUDA_MEGAKERNEL.nee_launches) == (3, 2)
    assert CUDA_SPHERES.launches == before
    assert bool(torch.isfinite(renderer.framebuffer).all())


# ptxas -v of the forms that predate next-event estimation, as they were
# built before it was added (sm_90a, CUDA 12.8): registers, spill stores,
# spill loads
_PTXAS = {
    "render_single<Lb0>": (95, 0, 0),
    "render_single<Lb1>": (96, 0, 0),
    "render_general<Lb0ELi0ELb1>": (72, 280, 254),
    "render_general<Lb1ELi0ELb1>": (72, 312, 334),
    "render_general<Lb1ELi1ELb1>": (72, 308, 342),
    "render_general<Lb1ELi2ELb1>": (72, 240, 230),
    "render_general<Lb1ELi0ELb0>": (72, 324, 358),
    "render_general<Lb1ELi1ELb0>": (72, 324, 358),
    "render_general<Lb1ELi2ELb0>": (72, 272, 270),
}


@pytest.mark.cuda
def test_forms_without_nee_keep_their_registers(tmp_path):
    """A fresh build of ``megakernel.cu``: twenty-one kernels, the nine that
    predate next-event estimation with their registers and spills, six NEE
    forms and six textured forms held to the general forms' 72
    registers."""
    _need_card()
    from ray_tracer_2_tpu_torch.kernels.cuda_build import (
        load_library, ptxas_summary,
    )
    got = ptxas_summary(load_library(CUDA_MEGAKERNEL.source, tmp_path)[2])
    assert {k: (v["registers"], v["spill_stores"], v["spill_loads"])
            for k, v in got.items() if k in _PTXAS} == _PTXAS
    nee = {k: v for k, v in got.items() if k.startswith("render_general_nee")}
    tex = {k: v for k, v in got.items() if k.startswith("render_general_tex")}
    assert len(nee) == len(tex) == 6 and len(got) == 21
    assert all(v["registers"] <= 72 for v in (*nee.values(), *tex.values()))


# ------------------------------------------------- textures and normal maps --
def _textured(build, every=7):
    """``build()`` with every ``every``-th entity's material textured."""
    return lambda a: scenes.textured_variant(build(), a, every=every)


def _textured_normal_map(a):
    """The normal-map quad with a diffuse texture too: one material with
    both maps."""
    return scenes.textured_variant(scenes.normal_map_scene(a), a)


# name -> (definition from an AssetManager, sphere_bvh, render options,
# spheres_mode, NEE mode)
_TEX_CELLS = {
    "sphere": (scenes.texture_sphere_scene, None, {}, 0, 0),
    "atrium": (lambda a: scenes.textured_atrium_scene(a, size=32), None, {},
               0, 0),
    "atrium_few": (lambda a: scenes.textured_atrium_scene(a, size=32,
                                                          every=10),
                   None, {}, 0, 0),
    "atrium_nee": (lambda a: scenes.textured_atrium_scene(a, size=32), None,
                   dict(nee=True), 0, 2),
    "room_nee": (_textured(scenes.room, every=2), None, dict(nee=True), 0, 1),
    "normal_map": (scenes.normal_map_scene, None, dict(normal_maps=True), 0,
                   0),
    "textured_normal_map": (_textured_normal_map, None,
                            dict(normal_maps=True), 0, 0),
    "balls_fast": (_textured(scenes.random_balls), None, {}, 1, 0),
    "balls_bvh": (_textured(scenes.random_balls), True, {}, 2, 0),
    "sunlit_fast_nee": (_textured(scenes.sunlit_balls), None,
                        dict(nee=True), 1, 1),
    "sunlit_bvh_nee": (_textured(scenes.sunlit_balls), True, dict(nee=True),
                       2, 2),
}


def _tex_cell(name, device="cuda"):
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    from ray_tracer_2_tpu_torch.kernels.megakernel import (
        kernel_tables, nee_mode, samples_textures,
    )
    make, bvh, opts, sph, mode = _TEX_CELLS[name]
    assets = AssetManager()
    scene = instantiate_scene(make(assets), assets, sphere_bvh=bvh).to(device)
    tab = kernel_tables(scene)
    assert samples_textures(scene, opts.get("normal_maps", False)), name
    assert (tab["spheres_mode"], tab["staged"],
            nee_mode(scene, opts.get("nee", False))) == (sph, False, mode), \
        name
    return scene, opts


def test_textured_cells_pick_their_forms():
    """Runs anywhere: each textured cell samples the atlas and takes the
    textured form it is named for (tables in global memory); together they
    cover the six."""
    forms = set()
    for name in _TEX_CELLS:
        _tex_cell(name, "cpu")
        _, _, opts, sph, mode = _TEX_CELLS[name]
        forms.add((sph, mode > 0))
    assert forms == {(m, n) for m in range(3) for n in (False, True)}


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [1, 5])
@pytest.mark.parametrize("name", list(_TEX_CELLS))
def test_textured_forms_match_plain(name, bounces):
    """Every textured form against ``render_plain`` at 128x72: textured
    spheres (sphere UVs) and meshes (interpolated UVs, past [0, 1]), every
    material textured or one in ten, normal maps alone and beside a
    diffuse texture, NEE in mode 1 and 2, the dense exact and fast loops
    and the sphere BVH. Bit-equal images, segments exact, row, leaf, box
    and shadow-ray counts equal, one launch of a textured form."""
    _need_card()
    scene, opts = _tex_cell(name)
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True, **opts)
    CUDA_MEGAKERNEL.reset_counts()
    ki, ks = CUDA_MEGAKERNEL(scene, 1, **kw)
    kc = CUDA_MEGAKERNEL.read_counts()
    pc = {}
    pi, ps = render_plain(scene, 1, counts=pc, **kw)
    torch.cuda.synchronize()
    assert CUDA_MEGAKERNEL.tex_launches == CUDA_MEGAKERNEL.launches == 1
    assert int(ks) == int(ps) == kc["active_lanes"]
    keys = ("rows", "leaves", "boxes") + (("shadow_rays",) if "nee" in opts
                                          else ())
    assert [kc[k] for k in keys] == [pc[k] for k in keys]
    assert pc["texture_taps"] > 0
    assert torch.equal(ki, pi)


@pytest.mark.cuda
def test_textured_frames_go_through_the_megakernel():
    """``Renderer.render`` on a textured small scene and with normal maps on
    the normal-map quad (a small scene too) launches the megakernel's
    textured forms, never the small-scene kernel; the same quad without
    normal maps the small-scene kernel."""
    _need_card()
    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    renderer = Renderer(device="cuda", mesh=None)
    CUDA_MEGAKERNEL.reset_counts()
    before = CUDA_SPHERES.launches
    a = AssetManager()
    metal = instantiate_scene(scenes.textured_variant(scenes.metal(), a), a)
    b = AssetManager()
    quad = instantiate_scene(scenes.normal_map_scene(b), b).to("cuda")
    params = RenderParams(width=64, height=36, bounces=3)
    renderer.render(metal.to("cuda"), params)
    renderer.render(quad, RenderParams(width=64, height=36, bounces=3,
                                       normal_maps=True))
    torch.cuda.synchronize()
    assert (CUDA_MEGAKERNEL.launches, CUDA_MEGAKERNEL.tex_launches) == (2, 2)
    assert CUDA_SPHERES.launches == before
    renderer.render(quad, params)
    torch.cuda.synchronize()
    assert CUDA_SPHERES.launches == before + 1
    assert bool(torch.isfinite(renderer.framebuffer).all())


# ---- the debug modes (csrc/debug.cu), batched frames and the Engine ------
_DEBUG_CELLS = {
    "room": lambda: instantiate_scene(scenes.room()),
    "wide_bvh": lambda: instantiate_scene(scenes.wide_bvh_scene()),
    "random_balls_bvh": lambda: instantiate_scene(scenes.random_balls(),
                                                  sphere_bvh=True),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(_DEBUG_CELLS))
def test_debug_kernel_matches_plain(name):
    """Every mode of ``csrc/debug.cu`` against the plain version at 96x54:
    colours of modes 1-4 on 99.9% of pixels within 1e-5, modes 5-7 equal,
    the per-ray counts of child boxes and triangles tested equal."""
    from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG, \
        render_debug_plain
    _need_card()
    sc = _DEBUG_CELLS[name]().to("cuda")
    kw = dict(width=96, height=54, debug_scale=100.0)
    plain, pc = render_debug_plain(sc, debug_mode=1, modes=range(1, 8), **kw)
    for m in range(1, 8):
        img, kc = CUDA_DEBUG(sc, debug_mode=m, **kw)
        assert torch.equal(kc, pc), m
        if m <= 4:
            assert _frac_within(img, plain[m]) >= 0.999, m
        else:
            assert torch.equal(img, plain[m]), m


@pytest.mark.cuda
def test_render_batch_on_the_card():
    """``render_batch`` bit-identical to single frames on the card, with the
    batch's segments as a device tensor."""
    _need_card()
    sc = instantiate_scene(scenes.wide_bvh_scene()).to("cuda")
    p = RenderParams(width=96, height=54, bounces=3)
    seq = Renderer(device="cuda", mesh=None)
    segs = 0
    for f in range(4):
        fb = seq.render(sc, dataclasses.replace(p, frames=f))
        segs += int(seq.last_segments)
    bat = Renderer(device="cuda", mesh=None)
    out = bat.render_batch(sc, p, 4)
    assert torch.equal(fb, out)
    assert bat.last_segments.is_cuda and int(bat.last_segments) == segs


@pytest.mark.cuda
def test_engine_camera_move_on_the_card():
    """``Engine`` on the card (``sponza``, the megakernel's scene): a
    camera move renders at half resolution
    with one bounce, and the first still frame after it is bit-equal to a
    fresh scene's at the new pose (the megakernel reads the camera row
    ``refresh_camera`` rewrote in place)."""
    from ray_tracer_2_tpu_torch.engine import Engine
    from ray_tracer_2_tpu_torch.scene.scenes import SceneName, \
        build_scene_definition
    _need_card()
    eng = Engine(96, 54, initial_scene=SceneName.SPONZA,
                 block_on_initial_scene=True, device="cuda", mesh=None)
    for _ in range(3):
        eng.update(dt=0.016)
    host = eng.scene_manager.scene
    host.camera.controller.process_mouse(0.3, 0.1)
    eng.update(dt=0.05, sync=True)
    assert (eng._last_params.width, eng._last_params.bounces) == (48, 1)
    first = eng.update(dt=0.016, sync=True).clone()
    definition = build_scene_definition(SceneName.SPONZA)
    definition.camera.transform = host.camera.transform.copy()
    fresh = instantiate_scene(definition).to("cuda")
    want = Renderer(device="cuda", mesh=None).render(
        fresh, dataclasses.replace(eng.params, frames=0))
    assert torch.equal(first, want)
    eng.scene_manager.shutdown()


# ---- live edits and the viewer (the cells of chip_smoke.py's edit_path)
@pytest.fixture(scope="module")
def edited():
    """``chip_smoke.edit_cases`` on the card, each scene's kernel tables
    built by a frame and then edited twice."""
    _need_card()
    from chip_smoke import edit_cases
    from ray_tracer_2_tpu_torch.scene.render_scene import \
        instantiate_host_scene
    kw = dict(width=128, height=72, bounces=5, rays_per_pixel=1, skybox=True)
    out = {}
    for name, host, opts, edit in edit_cases(scenes, instantiate_host_scene):
        kernel = CUDA_SPHERES if name.startswith("metal") else CUDA_MEGAKERNEL
        kernel(host.scene, 1, **kw, **opts)
        edit(host, 0)
        edit(host, 1)
        out[name] = (host, opts, kernel)
    return out


_EDIT_NAMES = ("random_balls + sphere BVH, sphere drag",
               "sponza(), material colour", "sponza(), glass toggle",
               "room2_scene + NEE, room box moved",
               "metal, sphere move (spheres.cu)")


@pytest.mark.cuda
@pytest.mark.parametrize("name", _EDIT_NAMES)
def test_edited_scene_kernel_matches_plain(edited, name):
    """After live edits the kernel frame is bit-equal to its plain version
    on the edited scene: the tables the kernel keeps (sphere and instance
    rows written in place, the dropped ones rebuilt) agree with the scene
    the plain version reads."""
    host, opts, kernel = edited[name]
    kw = dict(width=128, height=72, bounces=5, rays_per_pixel=1, skybox=True,
              **opts)
    ki, ks = kernel(host.scene, 1, **kw)
    plain = render_spheres_plain if kernel is CUDA_SPHERES else render_plain
    pi, ps = plain(host.scene, 1, **kw)
    assert int(ks) == int(ps)
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert torch.equal(ki, pi)


@pytest.mark.cuda
def test_viewer_serves_png_frames_from_the_card():
    """``ViewerServer`` over ``Engine(device="cuda")``: PNG frames of the
    megakernel's renders, an edit through POST /input reaching the scene
    on the card."""
    import json
    import threading
    import time
    import urllib.request
    from ray_tracer_2_tpu_torch.engine import Engine
    from ray_tracer_2_tpu_torch.scene.scenes import SceneName
    from ray_tracer_2_tpu_torch.viewer.server import ViewerServer
    _need_card()
    eng = Engine(160, 90, initial_scene=SceneName.METAL,
                 block_on_initial_scene=True, device="cuda", mesh=None)
    vs = ViewerServer(eng, port=0)
    CUDA_SPHERES.reset_counts()
    t = threading.Thread(target=vs.serve_forever)
    t.start()
    deadline = time.monotonic() + 60
    while (vs._httpd is None or vs._frame_id < 2) \
            and time.monotonic() < deadline:
        time.sleep(0.01)
    url = f"http://127.0.0.1:{vs._httpd.server_address[1]}"
    png = urllib.request.urlopen(url + "/frame.png", timeout=30).read()
    req = urllib.request.Request(url + "/input", method="POST", data=json.
                                 dumps({"edit_entity": {
                                     "kind": "sphere", "index": 1,
                                     "centre": [0.25, 0.0, -1.0]}}).encode())
    assert urllib.request.urlopen(req, timeout=30).status == 200
    vs.shutdown()
    t.join(timeout=60)
    assert not t.is_alive()
    assert png[:8] == b"\x89PNG\r\n\x1a\n"
    assert eng.scene_manager.scene.scene.sphere_pos[1].cpu().tolist() == \
        [0.25, 0.0, -1.0]
    assert CUDA_SPHERES.launches == eng._frame_counter > 0
    eng.scene_manager.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["room", "wide_bvh_scene"])
def test_debug_row_windows_on_the_card(name):
    """``csrc/debug.cu``'s row window: each window of a shuffled uneven
    split bit-equal to the same rows of the whole frame (colours and
    counts), in all seven modes."""
    from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG
    _need_card()
    sc = instantiate_scene(getattr(scenes, name)()).to("cuda")
    w, h = 96, 54
    rng = np.random.default_rng(11)
    cuts = sorted(rng.choice(np.arange(1, h), size=4, replace=False))
    windows = list(zip([0, *cuts], [*cuts, h]))
    rng.shuffle(windows)
    for m in range(1, 8):
        kw = dict(width=w, height=h, debug_mode=m, debug_scale=100.0)
        whole, counts = CUDA_DEBUG(sc, **kw)
        for a, b in windows:
            img, c = CUDA_DEBUG(sc, row_start=int(a), rows=int(b - a), **kw)
            assert torch.equal(img, whole[a:b]) and torch.equal(
                c, counts[a:b]), (m, a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("name, options", [
    ("metal", {}), ("wide_bvh_scene", {}), ("room", dict(nee=True)),
    ("room", dict(debug_mode=1))])
def test_row_tiles_on_the_card(name, options):
    """Row tiles over a mesh naming the card four times: the frame bit-equal
    to the single-device renderer's, segments equal, one launch a tile of
    the path's own kernel."""
    from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG
    from ray_tracer_2_tpu_torch.parallel import make_render_mesh
    _need_card()
    sc = instantiate_scene(getattr(scenes, name)()).to("cuda")
    p = RenderParams(width=96, height=56, bounces=3, frames=2, **options)
    single = Renderer(device="cuda", mesh=None)
    want = single.render(sc, p)
    kernels = (CUDA_MEGAKERNEL, CUDA_SPHERES, CUDA_DEBUG)
    before = [k.launches for k in kernels]
    sharded = Renderer(device="cuda", mesh=make_render_mesh(
        devices=["cuda:0"] * 4))
    got = sharded.render(sc, p)
    launched = [k.launches - b for k, b in zip(kernels, before)]
    assert sorted(launched) == [0, 0, 4], launched
    assert torch.equal(got.gather(), want)
    assert int(sharded.last_segments) == int(single.last_segments)
