"""The plain reference: the renderer's semantics in plain PyTorch, worked
out from the configuration's inputs alone (``scene``, ``camera``,
``tracer``), and the comparison that decides ``correct`` (``compare``).
Nothing here imports the program."""
