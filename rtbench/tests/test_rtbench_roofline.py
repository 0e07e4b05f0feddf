"""The frozen roofline arithmetic."""
import pytest

from rtbench import manifest
from rtbench.frozen import work


def test_per_segment_work_is_chip_smokes_sum():
    ops = work.per_segment_work(segments=10, boxes=600, leaves=8,
                                dense_spheres=1, brute_tris=2,
                                brute_instances=1, bvh_instances=1, taps=5)
    per_seg = 35 + 2 * 47 + 60 + 60 + 160
    assert ops == pytest.approx((600 * 34 + 8 * 376 + 10 * per_seg
                                 + 5 * 76) / 10)


def test_small_scene_work_tests_every_primitive():
    """A segment of the small-scene kernel: every sphere by the exact
    quadratic, every triangle by the pair test, then the shading; 17,135
    operations for random_balls' 485 spheres."""
    assert work.small_scene_work(485, 0) == 17_135
    assert work.small_scene_work(4, 12) == 4 * 35 + 12 * 47 + 160


def test_bound_takes_the_larger_side():
    assert work.bound_s(67e12, 0.0) == pytest.approx(1.0)
    assert work.bound_s(0.0, 3.35e12) == pytest.approx(1.0)
    assert work.bound_s(67e12, 6.7e12) == pytest.approx(2.0)


def test_roofline_reader():
    read = manifest.reader("megakernel_roofline").read
    tr = dict(work=dict(ops_per_segment=670.0, bytes_per_frame=0.0),
              segments=10 ** 9, frames=10,
              kernels=[("render_single(Params)", 0.0, 1e6, 0),
                       ("vectorized_elementwise_kernel<MulFunctor<float>>",
                        0.0, 5e5, 0)])
    # 6.7e11 operations at 67 TFLOP/s: 10 ms of bound in 1 s of kernel
    assert read(tr) == pytest.approx(1.0)
    assert read(dict(tr, kernels=[])) is None
    assert read(dict(tr, work=None)) is None


def test_every_cell_has_frozen_work():
    for w in manifest.load()["workloads"]:
        wk = manifest.cell_data(w["name"])["work"]
        assert wk["ops_per_segment"] > 0 and wk["bytes_per_frame"] > 0
