"""Multi-card rendering (port of ``ray_tracer_2_tpu/parallel/``)."""
from ray_tracer_2_tpu_torch.parallel.sharding import (  # noqa: F401
    RenderMesh, SceneReplicas, ShardedFramebuffer, auto_mesh,
    make_render_mesh, make_render_mesh2d, render_frame_hybrid_sharded,
    render_frame_mesh, render_frame_sharded, render_frame_spp_sharded,
    render_frames_batched_mesh, replicate_scene, shard_framebuffer,
)
