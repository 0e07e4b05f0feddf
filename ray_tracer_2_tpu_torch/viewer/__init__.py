"""The browser viewer of the port (``python -m ray_tracer_2_tpu_torch.viewer.server``)."""
from ray_tracer_2_tpu_torch.viewer.server import ViewerServer, run_viewer  # noqa: F401
