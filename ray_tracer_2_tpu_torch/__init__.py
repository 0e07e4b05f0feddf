"""ray_tracer_2_tpu_torch — the PyTorch + CUDA port of ``ray_tracer_2_tpu``.

The JAX package beside it is the reference: this package renders the same
scenes from the same host tables into the same images, on one NVIDIA H100.
It imports ``torch`` and never ``jax``, and nothing of the JAX package: the
reference's host side cannot be imported without jax (its package
``__init__`` files pull jnp in), so the port carries copies of the numpy
host builders it needs (``accel/``: BVH build, wide-row and attribute
packing; ``config.py``), and the tests pin that both build byte-identical
tables.

Layer map (mirrors the reference package):
  config.py  RenderParams, DebugMode
  accel/     SAH BVH (+ its C++ builder), wide rows, attribute rows
  rng.py     counter-hash RNG, bit-exact u32 emulation on int64 tensors
  math/      vector helpers on (..., 3) tensors; numpy transforms
  scene/     scene definition, camera, materials, TorchScene + instantiation
  kernels/   intersection, shading helpers, the persistent render
             (``kernels/megakernel.py``: plain PyTorch version + the
             hand-written CUDA kernel in ``csrc/megakernel.cu``)
  engine/    Renderer (progressive accumulation) and PNG export

This first slice covers the main path: one wide-BVH mesh instance plus up
to 32 dense spheres, no glass, textures, NEE or normal maps. Everything
else raises ``NotImplementedError`` naming its ROADMAP item.
"""

__version__ = "0.1.0"
