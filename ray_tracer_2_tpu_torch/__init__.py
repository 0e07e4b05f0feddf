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
  __main__.py  python -m ray_tracer_2_tpu_torch: progressive render to PNG
             with checkpoints
  config.py  RenderParams (+ the frame protocol), DebugMode, MAX_TEXTURES
  accel/     SAH BVH (+ its C++ builder), wide rows, attribute rows
  assets/    OBJ/MTL loading (+ its C++ tokenizer), textures and the texel
             atlas, the asset manager, procedural substitutes for files the
             repository lacks (sponza, the f1 car)
  rng.py     counter-hash RNG, bit-exact u32 emulation on int64 tensors
  math/      vector helpers on (..., 3) tensors; numpy transforms
  scene/     scene definition, camera and controller, materials,
             TorchScene + HostScene + instantiation, the background loader
  kernels/   intersection, shading helpers, texture sampling, the persistent
             render (``kernels/megakernel.py``: plain PyTorch version + the
             hand-written CUDA kernel in ``csrc/megakernel.cu``), the
             small-scene render, the brute-force kernel and the debug modes
             (``kernels/debug.py``, ``csrc/debug.cu``)
  engine/    Renderer (progressive accumulation, batched frames), Engine
             (the frame loop), checkpoints, PNG export
  viewer/    the browser viewer (stdlib HTTP + WebSocket, PNG frames) and
             its live scene edits
  probes/    the TPU probe scripts' kernels on the card
  spans.py   the port's spans and counters, recorded only while a
             torch.profiler session records (spans.record())

Not ported yet: several cards, the graft entry (ROADMAP Queue 1).
"""

__version__ = "0.1.0"
