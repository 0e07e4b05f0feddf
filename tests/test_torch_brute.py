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
