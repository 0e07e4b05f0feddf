"""Configurations: ``<config>.json`` (the sizes and their source, the file
``BENCHMARK.json`` names) and ``<config>.py`` (``inputs(spec, seed)``: the
scene as plain numpy data, which both the program and the reference are
given). A builder imports numpy and ``rtbench.frozen`` only. A material
is a dict under the program's ``MaterialDefinition`` field names, with
``texture`` for its diffuse texture: the keys ``reference.scene.material``
follows, which raises on any other."""
