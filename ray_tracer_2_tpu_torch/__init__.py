"""ray_tracer_2_tpu_torch — the PyTorch + CUDA port of ``ray_tracer_2_tpu``.

The JAX package beside it is the reference: this package renders the same
scenes from the same host tables into the same images, on one NVIDIA H100.
It imports ``torch`` and never ``jax``, and nothing of the JAX package: the
reference's host side cannot be imported without jax (its package
``__init__`` files pull jnp in), so the port carries copies of the numpy
host builders it needs (``accel/``: BVH build, wide-row and attribute
packing; ``assets/``: OBJ parsing, the texel atlas, the procedural
substitutes; ``config.py``), and the tests pin that both build
byte-identical tables.

Layer map (mirrors the reference package):
  config.py  RenderParams, DebugMode, MAX_TEXTURES
  accel/     SAH BVH (+ its C++ builder), wide rows, attribute rows
  assets/    OBJ/MTL loading (+ its C++ tokenizer), textures and the texel
             atlas, the asset manager, procedural substitutes for files the
             repository lacks (sponza, the f1 car)
  rng.py     counter-hash RNG, bit-exact u32 emulation on int64 tensors
  math/      vector helpers on (..., 3) tensors; numpy transforms
  scene/     scene definition, camera, materials, TorchScene + instantiation
  kernels/   intersection, shading helpers, texture sampling, the persistent
             render (``kernels/megakernel.py``: plain PyTorch version + the
             hand-written CUDA kernel in ``csrc/megakernel.cu``), the
             small-scene render and the brute-force kernel
  engine/    Renderer (progressive accumulation) and PNG export
  probes/    the TPU probe scripts' kernels on the card

Not ported yet: the debug modes (``NotImplementedError`` naming their
ROADMAP item), batched frames, the engine shell, several cards, the front
ends (ROADMAP Queue 1).
"""

__version__ = "0.1.0"
