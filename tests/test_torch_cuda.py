"""The CUDA kernels on the card, against their plain PyTorch versions there.

The main path's kernel (``csrc/megakernel.cu``) and the small-scene kernel
(``csrc/spheres.cu``). These tests need a CUDA card (the kernels have no
CPU mode) and skip without one. The file imports neither JAX nor the JAX package, so it also runs on
the GPU machine, which has no JAX; there, skip the JAX-importing conftest:

    python3 -m pytest --noconftest -q tests/test_torch_cuda.py
"""
import pytest
import torch

from ray_tracer_2_tpu_torch.config import RenderParams
from ray_tracer_2_tpu_torch.engine.renderer import Renderer
from ray_tracer_2_tpu_torch.kernels.megakernel import (
    CUDA_MEGAKERNEL, render_persistent, render_plain,
)
from ray_tracer_2_tpu_torch.kernels.spheres import (
    CUDA_SPHERES, render_spheres_plain,
)
from ray_tracer_2_tpu_torch.scene import scenes
from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


@pytest.fixture(scope="module")
def scene():
    _need_card()
    return instantiate_scene(scenes.wide_bvh_scene()).to("cuda")


@pytest.fixture(scope="module")
def small_scenes():
    _need_card()
    return {name: instantiate_scene(getattr(scenes, name)()).to("cuda")
            for name in ("random_balls", "room")}


def _frac_within(a, b, tol=1e-5):
    return float(((a - b).abs().amax(dim=-1) < tol).float().mean())


@pytest.mark.cuda
@pytest.mark.parametrize("bounces", [0, 5])
def test_kernel_matches_plain(scene, bounces):
    """Kernel and plain version share op order and the CUDA libm, so at
    every bounce count segments are exact and >= 99.9% of pixels agree
    within 1e-5 (the looser classes are for the CPU tests against JAX)."""
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    ki, ks = CUDA_MEGAKERNEL(scene, 1, **kw)
    pi, ps = render_plain(scene, 1, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ki).all())
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert int(ks) == int(ps)
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
def test_cuda_scenes_go_through_the_kernel(scene):
    before = CUDA_MEGAKERNEL.launches
    img, segs = render_persistent(scene, 0, width=64, height=36, bounces=2,
                                  rays_per_pixel=2, skybox=True,
                                  antialias=True, row_start=8, rows=20)
    torch.cuda.synchronize()
    assert CUDA_MEGAKERNEL.launches == before + 1
    assert tuple(img.shape) == (20, 64, 4) and img.is_cuda
    full, _ = render_plain(scene, 0, width=64, height=36, bounces=2,
                           rays_per_pixel=2, skybox=True, antialias=True)
    assert _frac_within(img, full[8:28]) >= 0.999
    assert int(segs) >= 2 * 20 * 64


@pytest.mark.cuda
def test_cuda_scene_on_cpu_renderer_raises(scene):
    renderer = Renderer(device="cpu")
    with pytest.raises(ValueError, match="scene.to"):
        renderer.render(scene, RenderParams(width=16, height=8))
    assert renderer.framebuffer is None
    Renderer(device="cuda").render(scene, RenderParams(width=16, height=8))


def test_wrapper_rejects_cpu_tensors():
    """Runs anywhere: the wrapper raises on CPU tensors instead of falling
    back to the plain version."""
    cpu = instantiate_scene(scenes.wide_bvh_scene())
    with pytest.raises(ValueError, match="CUDA tensors"):
        CUDA_MEGAKERNEL(cpu, 0, width=8, height=8, bounces=0,
                        rays_per_pixel=1, skybox=True)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["random_balls", "room"])
@pytest.mark.parametrize("bounces", [0, 5])
def test_spheres_kernel_matches_plain(small_scenes, name, bounces):
    """The small-scene kernel against its plain version, in the same class
    as the main path's: segments exact, >= 99.9% of pixels within 1e-5."""
    scene = small_scenes[name]
    kw = dict(width=128, height=72, bounces=bounces, rays_per_pixel=1,
              skybox=True)
    ki, ks = CUDA_SPHERES(scene, 1, **kw)
    pi, ps = render_spheres_plain(scene, 1, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(ki).all())
    assert float((pi[..., :3] > 0).any(dim=-1).float().mean()) >= 0.1
    assert int(ks) == int(ps)
    assert _frac_within(ki, pi) >= 0.999


@pytest.mark.cuda
def test_cuda_small_scene_goes_through_its_kernel(small_scenes):
    """Renderer.render on a CUDA sphere scene launches the small-scene
    kernel once per frame and the main path's kernel never."""
    renderer = Renderer(device="cuda")
    before = (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches)
    for f in range(2):
        renderer.render(small_scenes["random_balls"],
                        RenderParams(width=64, height=36, bounces=2,
                                     frames=f))
    torch.cuda.synchronize()
    assert (CUDA_SPHERES.launches, CUDA_MEGAKERNEL.launches) == \
        (before[0] + 2, before[1])
    assert renderer.framebuffer.is_cuda
    assert bool(torch.isfinite(renderer.framebuffer).all())


def test_spheres_wrapper_rejects_cpu_tensors():
    """Runs anywhere: the small-scene wrapper raises on CPU tensors instead
    of falling back to the plain version."""
    cpu = instantiate_scene(scenes.metal())
    with pytest.raises(ValueError, match="CUDA tensors"):
        CUDA_SPHERES(cpu, 0, width=8, height=8, bounces=0, rays_per_pixel=1,
                     skybox=True)
