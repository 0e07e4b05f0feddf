"""Host milliseconds a frame of ``Engine.update``'s camera step: the
controller, the camera written into the scene and the kernels' copy of it
(``refresh_camera`` → ``TorchScene.set_camera``), the frame protocol (the
program's span ``engine.camera``)."""
from rtbench.program_spans import ms_per_frame


def read(tr):
    return ms_per_frame("engine.camera")
