"""Asset loading (port of ``ray_tracer_2_tpu/assets``): OBJ/MTL files, PNG
textures and the texel atlas, the asset manager with its caches, and the
procedural substitutes for files the repository lacks."""
