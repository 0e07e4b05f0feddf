"""Sphere-heavy scenes through the port's megakernel, against the reference.

Host tables: a scene instantiated with the sphere BVH (``sphere_bvh=True``,
or by its size from ``SPHERE_BVH_MIN`` spheres) is byte-identical to the
reference's, which reads the same choice from ``RT2_SPHERE_BVH`` (set here
on the JAX side only): the wide rows with the sphere rows appended, the
sphere root, the depth.

Renders, the plain PyTorch version against JAX ``render_persistent`` with
the XLA boundary (``fused_boundary=False``), whose op order the port
follows, from identical tables at 96x54:

* the sphere BVH forced on ``random_balls``: at bounces 0 segments exact and
  >= 99% of pixels within 1e-5 (measured: every pixel); at bounces 3 the
  reference's own gate between its BVH and its dense path
  (``tests/test_sphere_bvh.py``): >= 98% of pixels within 1e-5, segments
  within 2% (measured: 98.9%, segments within 0.1%). The same gate holds
  the port's BVH path against the port's dense path (the blocked leaf
  quadratic and the shared-term dense formula differ by ulps, and a grazing
  hit on the 1000-radius ground sphere re-routes a path; measured: every
  pixel at bounces 0, 98.6% at bounces 3, segments within 0.24%);
* the dense fast path (485 spheres, the shared-term formula on both sides)
  with antialias, as ``Renderer`` routes ``random_balls`` with antialias;
* 100 spheres beside a wide-BVH mesh, which neither kernel of the port took
  before, dense and with the sphere BVH after the triangle instance
  (measured: segments exact, 99.9% of pixels).
"""
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.accel.bvh import build_bvh_bounds
from ray_tracer_2_tpu_torch.accel.wide import (
    COL_COUNT, COL_K, COL_LEAF_GEO, COL_SPH_ID, SPH_CHUNK,
    pack_sphere_wide_rows,
)
from ray_tracer_2_tpu_torch.config import RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels import megakernel
from ray_tracer_2_tpu_torch.kernels.intersect import \
    ray_sphere as megakernel_ray_sphere
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
from ray_tracer_2_tpu_torch.scene.render_scene import (
    FIELDS, SPHERE_BVH_MIN, STATICS, instantiate_scene, sphere_bvh_engaged,
)
from torch_bridge import (
    frac_within, port_render, ref_definition, ref_field, ref_render,
    torch_scene,
)
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

W, H = 96, 54


def _mesh_and_spheres(n: int = 99, seed: int = 5):
    """``wide_bvh_scene`` (one wide-BVH instance, one sphere) plus ``n``
    small spheres from ``seed`` around the mesh."""
    s = scenes.wide_bvh_scene()
    rng = np.random.default_rng(seed)
    for _ in range(n):
        centre = rng.uniform([-1.6, 0.0, -1.0], [1.6, 1.4, 1.6])
        s.add_sphere(centre.astype(np.float32),
                     float(rng.uniform(0.04, 0.12)),
                     MaterialDefinition.new().with_color(
                         [*rng.uniform(0.2, 0.9, 3), 1.0]))
    return s


DEFINITIONS = {
    "random_balls": (scenes.random_balls, True),
    "balls": (scenes.balls, True),
    "mesh_and_spheres": (_mesh_and_spheres, True),
    "random_balls_half24": (lambda: scenes.random_balls(half=24), None),
}


def _pair(name, monkeypatch):
    """(reference scene, port scene) of one definition, the sphere BVH
    forced (or left to the sphere count) on both sides."""
    make, forced = DEFINITIONS[name]
    definition = make()
    if forced is None:
        monkeypatch.delenv("RT2_SPHERE_BVH", raising=False)
    else:
        monkeypatch.setenv("RT2_SPHERE_BVH", "1" if forced else "0")
    rs = ref_instantiate(ref_definition(definition)).render_scene
    monkeypatch.delenv("RT2_SPHERE_BVH", raising=False)
    return rs, instantiate_scene(definition, sphere_bvh=forced)


@pytest.mark.parametrize("name", list(DEFINITIONS))
def test_sphere_bvh_tables_match_reference(name, monkeypatch):
    """Every tensor field and every static, ``sphere_bvh_root`` and
    ``wide_depth`` among them, equal to the reference's; ``balls`` (six
    spheres) gets no BVH even when asked, since the traversal enters
    through an interior root row."""
    rs, ts = _pair(name, monkeypatch)
    for f in FIELDS:
        want = ref_field(rs, f)
        got = getattr(ts, f).numpy()
        assert got.dtype == want.dtype and got.shape == want.shape, f
        assert np.array_equal(got, want), f
    for k in STATICS:
        want = getattr(rs, k)
        assert getattr(ts, k) == (tuple(want) if isinstance(want, (tuple,
                                                                   list))
                                  else want), k
    engaged = name != "balls"
    assert (ts.sphere_bvh_root >= 0) == engaged
    if engaged:
        root = ts.wide_rows[ts.sphere_bvh_root]
        assert float(root[COL_COUNT]) == 0.0 and float(root[COL_K]) >= 2
        assert ts.sphere_bvh_root == (
            0 if name != "mesh_and_spheres"
            else ts.wide_rows.shape[0] - _sphere_rows(ts))
    if name == "random_balls_half24":
        assert ts.n_spheres >= SPHERE_BVH_MIN
        assert instantiate_scene(DEFINITIONS[name][0](), sphere_bvh=False) \
            .sphere_bvh_root == -1


def _sphere_rows(ts) -> int:
    """Rows of the sphere BVH: from its root to the table's end."""
    return int(ts.wide_rows.shape[0] - ts.sphere_bvh_root)


def test_every_sphere_sits_in_one_leaf():
    """The packed sphere rows: each sphere's original id in exactly one
    leaf slot, its centre and squared radius beside it, -1 in the empty
    slots."""
    rng = np.random.default_rng(11)
    n = 203
    pos = rng.uniform(-5, 5, (n, 3)).astype(np.float32)
    rad = rng.uniform(0.05, 0.6, n).astype(np.float32)
    bvh = build_bvh_bounds(pos - rad[:, None], pos + rad[:, None], pos,
                           max_leaf=SPH_CHUNK)
    assert sorted(bvh.tri_order.tolist()) == list(range(n))
    o = bvh.tri_order
    rows, n_rows, depth = pack_sphere_wide_rows(bvh, pos[o], rad[o],
                                                row_offset=7)
    assert rows.shape == (n_rows, 128) and depth >= 2
    seen = []
    for r in rows[rows[:, COL_COUNT] > 0.5]:
        k = int(r[COL_COUNT])
        assert 1 <= k <= SPH_CHUNK
        ids = r[COL_SPH_ID:COL_SPH_ID + k].astype(np.int64)
        seen += ids.tolist()
        g = r[COL_LEAF_GEO:COL_LEAF_GEO + 4 * SPH_CHUNK].reshape(4, SPH_CHUNK)
        assert np.array_equal(g[:3, :k].T, pos[ids])
        assert np.array_equal(g[3, :k], rad[ids] * rad[ids])
        assert (g[3, k:] == -1.0).all()
    assert sorted(seen) == list(range(n))


def _leaf_rows(pos, rad, ids):
    """One sphere leaf row holding the given spheres, repeated per ray."""
    row = np.zeros(128, np.float32)
    k = len(ids)
    row[COL_COUNT] = k
    row[COL_LEAF_GEO + 3 * SPH_CHUNK:COL_LEAF_GEO + 4 * SPH_CHUNK] = -1.0
    for j in range(k):
        row[COL_SPH_ID + j] = ids[j]
        row[COL_LEAF_GEO + j] = pos[j][0]
        row[COL_LEAF_GEO + SPH_CHUNK + j] = pos[j][1]
        row[COL_LEAF_GEO + 2 * SPH_CHUNK + j] = pos[j][2]
        row[COL_LEAF_GEO + 3 * SPH_CHUNK + j] = np.float32(rad[j]) ** 2
    return torch.from_numpy(row)


def test_sphere_leaf_matches_the_dense_test():
    """The blocked 8-sphere leaf quadratic against the exact dense
    quadratic on the same five spheres (three slots empty): the same
    winner, distance bit for bit, and nothing where the dense test misses;
    a hit no nearer than the best so far is not taken."""
    rng = np.random.default_rng(3)
    n = 2000
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.uniform(-1, 1, (n, 3)) - o      # towards the spheres' box
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    pos = rng.uniform(-1, 1, (5, 3)).astype(np.float32)
    rad = rng.uniform(0.2, 0.6, 5).astype(np.float32)
    ids = [40, 7, 300, 12, 99]
    rows = _leaf_rows(pos, rad, ids).expand(n, -1)
    to, td = torch.from_numpy(o), torch.from_numpy(d)
    inf = torch.full((n,), megakernel.INF)
    sent = torch.full((n,), megakernel.SPH_SENT, dtype=torch.int64)
    better, dst, sid = megakernel._sphere_leaf_test(rows, to, td, inf, sent)
    tc, tr = torch.from_numpy(pos), torch.from_numpy(rad)
    hit, t, _ = megakernel_ray_sphere(to[:, None], td[:, None], tc[None],
                                      tr[None])
    want = t.argmin(dim=1)
    assert 0.1 < float(better.float().mean()) < 0.9
    assert torch.equal(better, hit.any(dim=1))
    assert torch.equal(dst[better], t.amin(dim=1)[better])
    assert torch.equal(sid[better], torch.tensor(ids)[want][better])
    again, _, _ = megakernel._sphere_leaf_test(rows, to, td, dst * 0.5, sent)
    assert not bool(again.any())


def test_sphere_leaf_tie_rules():
    """Equal distances: among spheres the lowest original id wins, wherever
    it sits in the leaf; against the best so far a sphere wins only with a
    lower id, so it beats a triangle or brute-force hit (whose traversal
    starts from ``SPH_SENT``) and loses to a lower-numbered sphere."""
    o = torch.tensor([[0.0, 0.0, 3.0]])
    d = torch.tensor([[0.0, 0.0, -1.0]])
    rows = _leaf_rows([[0, 0, 0], [5, 5, 5], [0, 0, 0]], [0.5, 0.1, 0.5],
                      [31, 2, 9])[None]
    inf = torch.tensor([megakernel.INF])
    sent = torch.tensor([megakernel.SPH_SENT])
    better, dst, sid = megakernel._sphere_leaf_test(rows, o, d, inf, sent)
    assert bool(better) and int(sid) == 9 and float(dst) == 2.5
    tie = torch.tensor([2.5])
    for best_id, wins in ((megakernel.SPH_SENT, True), (10, True),
                          (9, False), (3, False)):
        better, _, sid = megakernel._sphere_leaf_test(
            rows, o, d, tie, torch.tensor([best_id]))
        assert bool(better) == wins and int(sid) == 9


def test_engagement_rule():
    """By size from ``SPHERE_BVH_MIN``; forced on only above one leaf's
    worth of spheres; forced off always."""
    assert not sphere_bvh_engaged(SPHERE_BVH_MIN - 1, None)
    assert sphere_bvh_engaged(SPHERE_BVH_MIN, None)
    assert not sphere_bvh_engaged(SPH_CHUNK, True)
    assert sphere_bvh_engaged(SPH_CHUNK + 1, True)
    assert not sphere_bvh_engaged(10 * SPHERE_BVH_MIN, False)


@pytest.fixture(scope="module")
def random_balls_pair():
    mp = pytest.MonkeyPatch()
    try:
        return _pair("random_balls", mp)
    finally:
        mp.undo()


@pytest.mark.parametrize("bounces,need,seg_tol", [(0, 0.99, 0.0),
                                                  (3, 0.98, 0.02)])
def test_sphere_bvh_render_matches_reference(random_balls_pair, bounces,
                                             need, seg_tol):
    rs, ts = random_balls_pair
    a, sa = ref_render(rs, 0, fused=False, width=W, height=H, bounces=bounces,
                       lanes=512)
    b, sb = port_render(ts, 0, width=W, height=H, bounces=bounces)
    assert np.isfinite(b).all()
    assert abs(sa - sb) <= seg_tol * sa, (sa, sb)
    assert frac_within(a, b) >= need, frac_within(a, b)


@pytest.mark.parametrize("bounces,need,seg_tol", [(0, 0.99, 0.0),
                                                  (3, 0.98, 0.02)])
def test_sphere_bvh_render_matches_the_dense_path(random_balls_pair, bounces,
                                                  need, seg_tol):
    """The port against itself: the sphere BVH against the dense fast
    loop, and the BVH path's visit counts."""
    _, bvh = random_balls_pair
    dense = instantiate_scene(scenes.random_balls())
    assert dense.sphere_bvh_root == -1 and bvh.sphere_bvh_root == 0
    kw = dict(width=W, height=H, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    ca, cb = {}, {}
    a, sa = megakernel.render_plain(bvh, 0, counts=ca, **kw)
    b, sb = megakernel.render_plain(dense, 0, counts=cb, **kw)
    assert abs(int(sa) - int(sb)) <= seg_tol * int(sb)
    assert frac_within(a.numpy(), b.numpy()) >= need
    assert (cb["rows"], cb["leaves"], cb["boxes"]) == (0, 0, 0)
    # every segment evaluates the root row; most reach a leaf
    assert ca["rows"] >= int(sa) and ca["leaves"] > 0.5 * int(sa)
    assert ca["boxes"] >= 2 * ca["rows"]


@pytest.mark.parametrize("bounces,need,seg_tol", [(0, 0.95, 0.0),
                                                  (3, 0.97, 0.02)])
def test_dense_fast_path_with_antialias_matches_reference(bounces, need,
                                                          seg_tol):
    """``random_balls`` with antialias, two samples a pixel: 485 spheres
    through the shared-term dense formula on both sides. A first sample
    that flips moves the second sample's jitter, so the pixel gates are one
    step under the one-sample ones: >= 95% at bounces 0 (the antialias
    class of ``tests/test_torch_megakernel.py`` is 90%; measured here:
    every pixel, segments exact), >= 97% at bounces 3 (measured: 98.3%,
    segments within 0.06%)."""
    definition = scenes.random_balls()
    rs = ref_instantiate(ref_definition(definition)).render_scene
    ts = torch_scene(rs)
    assert ts.n_spheres == 485 and ts.sphere_bvh_root == -1
    assert megakernel.kernel_tables(ts)["spheres_mode"] == 1
    kw = dict(width=W, height=H, bounces=bounces, rays_per_pixel=2,
              antialias=True)
    a, sa = ref_render(rs, 1, fused=False, lanes=512, **kw)
    b, sb = port_render(ts, 1, **kw)
    assert np.isfinite(b).all()
    assert abs(sa - sb) <= seg_tol * sa, (sa, sb)
    assert frac_within(a, b) >= need, frac_within(a, b)


@pytest.mark.parametrize("forced", [False, True])
def test_mesh_and_100_spheres_match_reference(forced, monkeypatch):
    """100 spheres beside a 1,496-triangle wide-BVH instance at bounces 2:
    dense (the fast formula) and with the sphere BVH as the phase after
    the triangle instance. Segments within 1%, >= 98% of pixels within
    1e-5."""
    monkeypatch.setenv("RT2_SPHERE_BVH", "1" if forced else "0")
    definition = _mesh_and_spheres()
    rs = ref_instantiate(ref_definition(definition)).render_scene
    monkeypatch.delenv("RT2_SPHERE_BVH")
    ts = instantiate_scene(definition, sphere_bvh=forced)
    assert ts.n_spheres == 100 and (ts.sphere_bvh_root >= 0) == forced
    assert rs.sphere_bvh_root == ts.sphere_bvh_root
    assert megakernel.ineligibility(ts) is None
    kw = dict(width=64, height=36, bounces=2)
    a, sa = ref_render(rs, 0, fused=False, lanes=512, **kw)
    b, sb = port_render(ts, 0, **kw)
    assert abs(sa - sb) <= 0.01 * sa, (sa, sb)
    assert frac_within(a, b) >= 0.98, frac_within(a, b)


def test_renderer_takes_every_sphere_scene_of_the_slice():
    """``Renderer(device="cpu")`` renders what raised before: random_balls
    with antialias, with the sphere BVH, at 2,305 spheres, 100 spheres
    beside a mesh, and five 256-triangle groups."""
    cases = [(instantiate_scene(scenes.random_balls()), True),
             (instantiate_scene(scenes.random_balls(), sphere_bvh=True),
              False),
             (instantiate_scene(scenes.random_balls(half=24)), False),
             (instantiate_scene(_mesh_and_spheres()), False),
             (instantiate_scene(scenes.groups_scene(5)), False)]
    for scene, antialias in cases:
        assert megakernel.ineligibility(scene) is None
        r = Renderer(device="cpu")
        fb = r.render(scene, RenderParams(width=24, height=14, bounces=2,
                                          antialias=antialias))
        assert bool(torch.isfinite(fb).all())
        assert int(r.last_segments) >= 24 * 14
        assert float(fb[..., :3].max()) > 0.0
