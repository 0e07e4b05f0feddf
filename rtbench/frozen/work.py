"""The work a segment does, in the megakernel and in the small-scene
kernel, and the card's peaks: frozen copies of ``chip_smoke.py``'s
per-visit operation constants (``OPS_*``, ``TAP_BYTES``) and of
``ray_tracer_2_tpu_torch/probes/common.py``'s peaks (``PEAK_FLOPS``,
``PEAK_BYTES_PER_S``) and ``bound``.

The roofline of a cell is not worked out from the program's own visit
counts at run time, since a faster traversal would then change the
yardstick. ``per_segment_work`` was evaluated once, from the parent tree's
device counters on the card, and its result is written into the
configuration's data file (``frozen_work``); a run multiplies it by the
exact segments it traced.
"""
from __future__ import annotations

#: NVIDIA H100 SXM, float32 outside the tensor cores, at 700 W (data sheet)
PEAK_FLOPS = 67e12
#: its HBM3 rate
PEAK_BYTES_PER_S = 3.35e12

OPS_BOX = 34            # megakernel.cu child_eval, per child box
OPS_LEAF = 8 * 47       # megakernel.cu traverse, per leaf of 8 triangles
OPS_SPHERE = 35         # the exact quadratic, per dense sphere
OPS_BRUTE = 47          # brute.cuh test_row, per ray-triangle pair
OPS_INSTANCE = 60       # megakernel.cu instance ray, limit, merge
OPS_SEGMENT = 160       # camera ray share, shading, roulette per segment
OPS_TAP = 76            # megakernel.cu sample_quads, per texel quad fetched
TAP_BYTES = 16          # one int4 texel quad a tap


def per_segment_work(*, segments: int, boxes: int, leaves: int,
                     dense_spheres: int, brute_tris: int,
                     brute_instances: int, bvh_instances: int,
                     taps: int = 0) -> float:
    """Operations a segment costs on average, from counts over a number of
    frames: ``chip_smoke.py:megakernel_bound``'s sum (child boxes, leaves
    of 8 triangles, per segment the dense spheres, brute-force triangles and
    instance rays, the shading; each texel quad fetched) over the segments."""
    prepass = (dense_spheres * OPS_SPHERE + brute_tris * OPS_BRUTE
               + brute_instances * OPS_INSTANCE)
    per_seg = prepass + bvh_instances * OPS_INSTANCE + OPS_SEGMENT
    ops = boxes * OPS_BOX + leaves * OPS_LEAF + segments * per_seg \
        + taps * OPS_TAP
    return ops / segments


def small_scene_work(spheres: int, tris: int) -> float:
    """Operations a segment of the small-scene kernel (``csrc/spheres.cu``)
    costs by the semantics: every sphere and every triangle tested densely,
    then the shading. A sphere counts as the exact quadratic
    (``OPS_SPHERE``) whatever form the kernel tests it in, so the yardstick
    does not move with the implementation."""
    return spheres * OPS_SPHERE + tris * OPS_BRUTE + OPS_SEGMENT


def bound_s(ops: float, nbytes: float) -> float:
    """The least time the card could take: the larger of ``ops`` over the
    float32 peak and ``nbytes`` over the memory rate (``probes/common.py``
    ``bound``)."""
    return max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES_PER_S)
