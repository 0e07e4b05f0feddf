"""The port's brute-force closest hit against the reference's.

``brute_force_intersect_plain`` (the CPU path of ``kernels/brute.py`` and
the prepass of the plain megakernel) is held against the JAX package's
``brute_force_intersect`` (its XLA loop) and ``_brute_pallas`` (the Pallas
kernel, which runs in the interpreter on the CPU as in
tests/test_pallas_brute.py), on 300 rays from a numpy seed against three
groups: room2's 16-triangle quad group, a 192-triangle lat/lon soup, and
the same soup in glass, whose triangles are two-sided. ``tri`` and ``mat``
must be exact and ``dst`` within rtol 1e-5 on hits (XLA contracts and
reorders the cross products' sums its own way: 7e-7 apart at most here).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tracer_2_tpu.kernels.brute import _brute_pallas, \
    brute_force_intersect as ref_brute
from ray_tracer_2_tpu.scene.render_scene import \
    instantiate_scene as ref_instantiate
from ray_tracer_2_tpu_torch.kernels.brute import (
    CUDA_BRUTE, brute_force_intersect, brute_force_intersect_plain,
    pack_brute_table,
)
from ray_tracer_2_tpu_torch.math.transform import Transform
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.definition import MeshFromData, \
    SceneDefinition
from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
from torch_bridge import ref_definition, torch_scene
from torch_bridge import one_torch_thread  # noqa: F401 (autouse)

N_RAYS = 300


def _soup(glass: bool) -> SceneDefinition:
    s = SceneDefinition()
    mat = MaterialDefinition.new().with_color([0.8, 0.3, 0.2, 1.0])
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(8, 12)),
               mat.glass(1.5) if glass else mat)
    return s


#: name -> (scene definition, instance of the group, box the rays start in)
GROUPS = {
    "room2_quads": (lambda: scenes.room2_scene(12, 12), 2,
                    ([-2.8, 0.2, -1.8], [2.8, 3.8, 1.8])),
    "soup_192": (lambda: _soup(False), 0, ([-1.5] * 3, [1.5] * 3)),
    "soup_192_glass": (lambda: _soup(True), 0, ([-1.5] * 3, [1.5] * 3)),
}


@pytest.fixture(scope="module", params=list(GROUPS))
def group(request):
    make, inst, (lo, hi) = GROUPS[request.param]
    rs = ref_instantiate(ref_definition(make())).render_scene
    _, tri_off, count = rs.inst_spans[inst]
    rng = np.random.default_rng(7)
    o = rng.uniform(lo, hi, (N_RAYS, 3)).astype(np.float32)
    d = rng.normal(size=(N_RAYS, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    return request.param, rs, torch_scene(rs), tri_off, count, o, d


def _port(ts, tri_off, count, o, d):
    r = brute_force_intersect_plain(ts, torch.from_numpy(o),
                                    torch.from_numpy(d), tri_off, count)
    return {k: r[k].numpy() for k in ("dst", "tri", "u", "v", "det", "mat")}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_matches_reference(group, impl):
    name, rs, ts, tri_off, count, o, d = group
    fn = ref_brute if impl == "xla" else _brute_pallas
    a = fn(rs, jnp.asarray(o), jnp.asarray(d), tri_off, count)
    b = _port(ts, tri_off, count, o, d)
    hit = np.asarray(a["tri"]) >= 0
    assert 20 <= hit.sum() < N_RAYS, name
    np.testing.assert_array_equal(np.asarray(a["tri"]), b["tri"])
    np.testing.assert_array_equal(np.asarray(a["mat"]), b["mat"])
    np.testing.assert_allclose(np.asarray(a["dst"])[hit], b["dst"][hit],
                               rtol=1e-5)


def test_table_is_the_references(group):
    """``pack_brute_table`` holds what ``_brute_pallas`` packs: the
    vertices, the canonical material id and the cull flag (1 unless the
    material is glass)."""
    name, rs, ts, tri_off, count, _, _ = group
    sl = slice(tri_off, tri_off + count)
    mats = np.asarray(rs.tri_mat)[sl]
    cull = np.asarray(rs.materials.flag)[mats] != 1
    want = np.concatenate([np.asarray(rs.tri_v0)[sl],
                           np.asarray(rs.tri_v1)[sl],
                           np.asarray(rs.tri_v2)[sl],
                           mats[:, None].astype(np.float32),
                           cull[:, None].astype(np.float32),
                           np.zeros((count, 5), np.float32)], axis=1)
    got = pack_brute_table(ts, tri_off, count)
    assert got.dtype == torch.float32 and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    assert bool(cull.all()) == (name != "soup_192_glass")


def test_cpu_tensors_take_the_plain_version(group):
    _, _, ts, tri_off, count, o, d = group
    before = CUDA_BRUTE.launches
    r = brute_force_intersect(ts, torch.from_numpy(o), torch.from_numpy(d),
                              tri_off, count)
    want = _port(ts, tri_off, count, o, d)
    for k in want:
        np.testing.assert_array_equal(r[k].numpy(), want[k], k)
    assert r["stats"].shape == (N_RAYS, 2)
    assert bool((r["stats"][:, 1] == count).all())
    assert CUDA_BRUTE.launches == before


# ------------------------------------------------------------ edge cases --
# The list the CUDA kernel is held to on the card (tests/test_torch_cuda.py,
# chip_smoke.py), here against three referees. ``tri`` and ``mat`` exact,
# ``dst`` within EDGE_RTOL (the file's tolerance above), ``u, v, det``
# within EDGE_RTOL plus EDGE_ATOL against JAX, bit for bit against numpy.
#
# * A numpy float32 model with the written operation order (no
#   contraction: numpy rounds every product and sum): exact on every case,
#   the knife-edge ones included.
# * The JAX functions, the XLA loop and the Pallas kernel in the
#   interpreter: exact on every case that is not ``knife_edge``. XLA's CPU
#   backend contracts ``a * b + c`` into a fused multiply-add, so on the
#   ``knife_edge`` cases (rays aimed at an edge or a vertex in general
#   position) the sign of a barycentric of the order of 1e-8 may come out
#   the other way: there the JAX functions are held to the plain version on
#   the rays whose record no such pair decides, and on the others to one of
#   the two records the model gives with the edge taken as a hit or a miss.
from types import SimpleNamespace  # noqa: E402

from ray_tracer_2_tpu_torch.kernels.brute_cases import (  # noqa: E402
    GLASS_IDS, N_MATERIALS, SIZES, edge_cases, table_scene,
)

EDGE_RTOL = 1e-5
#: absolute room of u, v and det against JAX: they are sums of products of
#: the order of 1 that cancel (a cross product of the ray with an edge), so
#: a contracted product moves them by a few 1e-6 whatever their own size
EDGE_ATOL = 2e-5
CASES = {c.name: c for c in edge_cases()}
#: a barycentric whose numerator (the barycentric times det, a sum of
#: products of the order of 1) is this near 0 is on a knife edge: either
#: decision is right
MARGIN = 1e-6


def _np_pairs(case):
    """Möller–Trumbore of every (ray, triangle) pair in numpy float32, in
    the order ``kernels/intersect.py:ray_triangle`` writes it. Returns
    (hit, dst, u, v, w, det), each (B, T)."""
    f = np.float32
    v0, v1, v2 = (a[None] for a in (case.v0, case.v1, case.v2))
    o, d = case.origin[:, None], case.direction[:, None]
    cull = ~np.isin(case.mat, GLASS_IDS)[None]

    def cross(a, b):
        return np.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                         a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                         a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)

    def dot(a, b):
        return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) \
            + a[..., 2] * b[..., 2]

    e1, e2 = v1 - v0, v2 - v0
    n = cross(e1, e2)
    ao = o - v0
    dao = cross(ao, np.broadcast_to(d, ao.shape))
    det = -dot(d, n)
    keep = np.where(cull, det >= f(1e-8), np.abs(det) >= f(1e-8))
    with np.errstate(all="ignore"):
        inv = f(1.0) / np.where(keep, det, f(1.0))
        dst = dot(ao, n) * inv
        u = dot(e2, dao) * inv
        v = -dot(e1, dao) * inv
        w = (f(1.0) - u) - v
    hit = keep & (dst > f(1e-5)) & (u >= 0) & (v >= 0) & (w >= 0)
    assert dst.dtype == np.float32
    return hit, dst, u, v, w, det


def _winner(case, hit, pairs):
    _, dst, u, v, _, det = pairs
    d = np.where(hit, dst, np.float32(1.7014118e38))
    k = d.argmin(1)                     # the first index of the least
    rows = np.arange(len(k))
    got = hit[rows, k]
    pick = lambda x: np.where(got, x[rows, k], 0).astype(x.dtype)
    return dict(dst=np.where(got, d[rows, k], np.float32(1.7014118e38)),
                tri=np.where(got, k, -1), u=pick(u), v=pick(v),
                det=pick(det), mat=np.where(got, case.mat[k], 0))


def _np_model(case):
    pairs = _np_pairs(case)
    return _winner(case, pairs[0], pairs)


def _np_model_either_way(case):
    """The model's record with every pair on a knife edge (the numerator
    of u, v or w, i.e. the barycentric times det, within ``MARGIN`` of 0)
    counted as a hit, and with every such pair counted as a miss: what an
    implementation that rounds otherwise may return."""
    pairs = _np_pairs(case)
    hit, dst, u, v, w, det = pairs
    with np.errstate(all="ignore"):
        s = np.abs(det)
        near = np.minimum.reduce([np.abs(u), np.abs(v), np.abs(w)]) * s \
            < MARGIN
        inside = (u * s >= -MARGIN) & (v * s >= -MARGIN) & (w * s >= -MARGIN)
    cull = ~np.isin(case.mat, GLASS_IDS)[None]
    keep = np.where(cull, det >= 1e-8, np.abs(det) >= 1e-8)
    as_hit = hit | (near & inside & keep & (dst > 1e-5))
    return _winner(case, as_hit, pairs), _winner(case, hit & ~near, pairs)


def _check_record(got, want, rays, what=""):
    """``got`` against ``want`` on the rays of the boolean mask ``rays``."""
    np.testing.assert_array_equal(got["tri"][rays], want["tri"][rays], what)
    np.testing.assert_array_equal(got["mat"][rays], want["mat"][rays], what)
    hit = rays & (want["tri"] >= 0)
    for k in ("dst", "u", "v", "det"):
        np.testing.assert_allclose(got[k][hit], want[k][hit], rtol=EDGE_RTOL,
                                   atol=1e-6 if k == "dst" else EDGE_ATOL,
                                   err_msg=k + what)
    assert (got["dst"][rays & (want["tri"] < 0)] >= 1.7e38).all()


def _port_case(case):
    r = brute_force_intersect_plain(
        table_scene(case), torch.from_numpy(case.origin),
        torch.from_numpy(case.direction), 0, case.count)
    return {k: r[k].numpy() for k in ("dst", "tri", "u", "v", "det", "mat")}


def test_case_list_covers_the_sizes():
    assert [f"soup_{n}" in CASES for n in SIZES] == [True] * len(SIZES)
    assert sum(c.knife_edge for c in CASES.values()) == 2
    assert N_MATERIALS == 4 and set(GLASS_IDS) == {1, 3}


@pytest.mark.parametrize("name", list(CASES))
def test_edge_case_against_the_numpy_model(name):
    """Every case, the knife-edge ones included: the plain version decides
    each ray as the float32 model with the written operation order does,
    bit for bit in ``dst, u, v, det``."""
    case = CASES[name]
    got, want = _port_case(case), _np_model(case)
    assert int((want["tri"] >= 0).sum()) >= case.min_hits
    np.testing.assert_array_equal(got["tri"], want["tri"])
    np.testing.assert_array_equal(got["mat"], want["mat"])
    for k in ("dst", "u", "v", "det"):
        np.testing.assert_array_equal(got[k], want[k], k)


def _ref_scene(case):
    flag = np.zeros(N_MATERIALS, np.int32)
    flag[list(GLASS_IDS)] = 1
    return SimpleNamespace(
        tri_v0=jnp.asarray(case.v0), tri_v1=jnp.asarray(case.v1),
        tri_v2=jnp.asarray(case.v2), tri_mat=jnp.asarray(case.mat),
        materials=SimpleNamespace(flag=jnp.asarray(flag)))


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("name", list(CASES))
def test_edge_case_against_the_reference(name, impl):
    """The plain version against the JAX package's two functions: every ray
    of the cases contraction cannot decide. On the knife-edge cases, the
    rays whose record does not hang on a pair within ``MARGIN`` of an edge
    must agree with the plain version, and on the others (at least a quarter)
    JAX must return the model's record with the edge taken as a hit or as
    a miss."""
    case = CASES[name]
    fn = ref_brute if impl == "xla" else _brute_pallas
    a = fn(_ref_scene(case), jnp.asarray(case.origin),
           jnp.asarray(case.direction), 0, case.count)
    a = {k: np.asarray(a[k]) for k in ("dst", "tri", "u", "v", "det", "mat")}
    b = _port_case(case)
    every = np.ones(len(case.origin), bool)
    if not case.knife_edge:
        _check_record(a, b, every, f" ({name}, {impl})")
        return
    as_hit, as_miss = _np_model_either_way(case)
    undecided = as_hit["tri"] != as_miss["tri"]
    assert undecided.sum() >= len(every) // 4     # the case is a knife edge
    _check_record(a, b, ~undecided, f" ({name}, {impl}, decided)")
    took_hit = a["tri"] == as_hit["tri"]
    assert (took_hit | (a["tri"] == as_miss["tri"]))[undecided].all()
    _check_record(a, as_hit, undecided & took_hit, " (edge taken as a hit)")
    _check_record(a, as_miss, undecided & ~took_hit, " (edge taken as a miss)")


def test_edge_cases_pack_like_the_reference():
    """``pack_brute_table`` on a case's table: the reference's columns, the
    cull flag 0 on the glass ids."""
    case = CASES["soup_17"]
    tab = pack_brute_table(table_scene(case), 0, case.count).numpy()
    np.testing.assert_array_equal(tab[:, 0:3], case.v0)
    np.testing.assert_array_equal(tab[:, 6:9], case.v2)
    np.testing.assert_array_equal(tab[:, 9], case.mat.astype(np.float32))
    np.testing.assert_array_equal(tab[:, 10] == 0.0,
                                  np.isin(case.mat, GLASS_IDS))
    assert not tab[:, 11:].any()
