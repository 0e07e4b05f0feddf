"""Progressive renderer, the engine shell, checkpoints and PNG export."""
from ray_tracer_2_tpu_torch.engine.renderer import Renderer  # noqa: F401
from ray_tracer_2_tpu_torch.engine.engine import (  # noqa: F401
    Engine, FrameStats, FrameTiming,
)
from ray_tracer_2_tpu_torch.engine.export import (  # noqa: F401
    framebuffer_to_srgb, save_png,
)
