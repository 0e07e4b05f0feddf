"""The reference follows glass: the program's plain path, driven through
``rtbench.program.engine`` on scenes built here, against
``compare.reference_outputs`` on the CPU.

* a small glass scene (a clear glass sphere, an absorbing one with spheres
  seen through it, a two-sided glass quad, a diffuse floor) on the
  small-scene path, and the same with a textured wall, which sends it
  through the megakernel;
* the final scene of Ray Tracing in One Weekend (upstream ``random_balls``,
  ``scene.rs:365-444``), built here from its published rules;
* a reference that shades glass as diffuse, and the bfloat16 control, are
  judged not correct on the first scene's record;
* a material key or flag the reference does not follow raises."""
import numpy as np
import pytest
import torch

from rtbench import harness, traffic
from rtbench.frozen.images import seeded_image_u8
from rtbench.reference import compare, scene as ref_scene
from rtbench.reference.scene import RefScene

#: bounds of the glass scenes, and of the sponza tests (random_balls)
GLASS_BOUNDS = dict(mismatch_share=0.005, segments_gap=0.005)
SPONZA_BOUNDS = dict(mismatch_share=0.02, segments_gap=0.01)


def quad(corners, normal):
    """Two triangles over the corners (counter-clockwise seen from the
    side ``normal`` points to): positions, normals and UVs per corner."""
    c = np.asarray(corners, np.float32)
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    k = [0, 1, 2, 0, 2, 3]
    return dict(pos=c[k], nrm=np.tile(np.asarray(normal, np.float32), (6, 1)),
                uv=uvs[k])


IDENTITY = dict(pos=[0.0, 0.0, 0.0], axis=[0.0, 1.0, 0.0], angle=0.0,
                scale=[1.0, 1.0, 1.0])


def glass_scene(textured: bool = False) -> dict:
    diffuse = lambda rgb, **kw: dict(color=[*rgb, 1.0], smoothness=0.0,
                                     **kw)
    meshes = [
        dict(quad([[-8, 0, 8], [8, 0, 8], [8, 0, -8], [-8, 0, -8]],
                  [0, 1, 0]), transform=IDENTITY,
             material=diffuse([0.6, 0.6, 0.55])),
        dict(quad([[-2.6, 0.3, 2.2], [-0.2, 0.3, 2.2], [-0.2, 2.1, 2.2],
                   [-2.6, 2.1, 2.2]], [0, 0, 1]), transform=IDENTITY,
             material=dict(flag=1, ior=1.5, specular=0.5, smoothness=1.0)),
    ]
    images = {}
    if textured:
        images["wall"] = seeded_image_u8(64, 7)
        meshes.append(dict(
            quad([[-6, 0, -4], [6, 0, -4], [6, 5, -4], [-6, 5, -4]],
                 [0, 0, 1]), transform=IDENTITY,
            material=dict(texture="wall", smoothness=0.0)))
    spheres = [
        dict(centre=[-1.3, 1.0, 0.0], radius=1.0,
             material=dict(flag=1, ior=1.5, specular=1.0, smoothness=1.0)),
        dict(centre=[1.3, 1.0, 0.3], radius=1.0,
             material=dict(flag=1, ior=1.33, specular=0.8, smoothness=0.9,
                           absorption=[0.9, 0.25, 0.05, 0.0],
                           absorption_strength=1.5)),
        dict(centre=[1.6, 0.6, -2.0], radius=0.6,
             material=diffuse([0.2, 0.8, 0.2], specular=0.3,
                              specular_color=[1.0, 1.0, 1.0, 1.0])),
        dict(centre=[0.0, 0.5, -2.5], radius=0.5,
             material=diffuse([0.8, 0.1, 0.1])),
        dict(centre=[-2.5, 0.4, -2.0], radius=0.4,
             material=diffuse([0.1, 0.2, 0.9])),
        dict(centre=[0.0, 5.0, -3.0], radius=1.0,
             material=dict(color=[0.1, 0.1, 0.1, 1.0],
                           emission_color=[1.0, 0.9, 0.8, 1.0],
                           emission_strength=3.0)),
    ]
    return dict(camera=dict(pos=[0.0, 1.6, 7.0], target=[0.0, 0.9, 0.0],
                            fov=40.0, aspect=16.0 / 9.0, focus_dist=1.0,
                            defocus_strength=0.0, diverge_strength=0.0),
                meshes=meshes, spheres=spheres, images=images)


def random_balls(seed: int = 42, half: int = 11) -> dict:
    """Upstream ``random_balls`` (scene.rs:365-444): a ground sphere, three
    large ones (glass n = 1.5, diffuse, metal) and one small sphere a cell
    of ``range(-half, half)`` squared, drawn from ``default_rng(seed)`` in
    upstream's order: 80% diffuse, 15% fuzzed metal, 5% glass (n = 1.3).
    Materials start from upstream's ``MaterialDefinition::new``."""
    new = lambda **kw: dict(dict(color=[1.0] * 4, emission_color=[1.0] * 4,
                                 specular_color=[1.0] * 4, smoothness=0.0,
                                 specular=0.1, ior=0.0), **kw)
    ball = lambda c, r, m: dict(centre=[float(x) for x in c], radius=r,
                                material=m)
    spheres = [
        ball([0, -1000, 0], 1000.0, new(color=[0.5, 0.5, 0.5, 1.0])),
        ball([0, 1, 0], 1.0, new(ior=1.5, flag=1)),
        ball([-4, 1, 0], 1.0, new(color=[0.4, 0.2, 0.1, 1.0])),
        ball([4, 1, 0], 1.0, new(color=[0.7, 0.6, 0.5, 1.0],
                                 specular_color=[0.7, 0.6, 0.5, 1.0],
                                 specular=1.0, smoothness=1.0)),
    ]
    rng = np.random.default_rng(seed)
    for a in range(-half, half):
        for b in range(-half, half):
            mat = rng.random()
            centre = np.array([a + 0.9 * rng.random(), 0.2,
                               b + 0.9 * rng.random()], np.float32)
            if np.linalg.norm(centre - np.array([4.0, 0.2, 0.0])) <= 0.9:
                continue
            if mat < 0.8:
                albedo = [rng.random(), rng.random(), rng.random(), 1.0]
                spheres.append(ball(centre, 0.2, new(color=albedo)))
            elif mat < 0.95:
                albedo = [rng.uniform(0.5, 1.0), rng.uniform(0.5, 1.0),
                          rng.uniform(0.5, 1.0), 1.0]
                spheres.append(ball(centre, 0.2, new(
                    color=albedo, specular=rng.uniform(0.0, 0.5))))
            else:
                spheres.append(ball(centre, 0.2, new(ior=1.3, flag=1)))
    return dict(camera=dict(pos=[13.0, 2.0, 3.0], target=[0.0, 0.0, 0.0],
                            fov=20.0, aspect=16.0 / 9.0, focus_dist=10.0,
                            defocus_strength=0.0, diverge_strength=0.0),
                meshes=[], spheres=spheres, images={})


def record(inputs: dict, seed: int, size: tuple, small: bool,
           monkeypatch=None) -> dict:
    """A still window of no length (the mix's warm frames and one more) on
    the CPU, with the route the scene takes checked first. With
    ``monkeypatch`` every pixel of the frame is compared, not the run's
    seeded sample."""
    from ray_tracer_2_tpu_torch.engine import renderer

    def route(eng):
        assert renderer.small_scene(eng.scene_manager.scene.scene) is small

    if monkeypatch is not None:
        monkeypatch.setattr(harness, "STILL_PIXELS", size[0] * size[1])
    run = harness.drive_inputs(inputs, traffic.load("still"), seed, 0.0,
                               False, "cpu", size, hook=route)
    assert run["n_frames"] == 5 and run["bounces"] == 5
    return run


def found(run: dict, ref: dict) -> dict:
    return compare.numbers(run["values"], ref["values"],
                           run["last_segments"], ref["segments"])


def within(numbers: dict, bounds: dict) -> bool:
    return all(numbers[k] <= v for k, v in bounds.items())


@pytest.fixture(scope="module")
def glass_run():
    inputs = glass_scene()
    return record(inputs, 2 ** 31 + 21, (64, 36), small=True), inputs


@pytest.mark.parametrize("textured", [False, True],
                         ids=["small_scene_path", "megakernel"])
def test_glass_scene_matches(textured, glass_run):
    if textured:
        inputs = glass_scene(textured=True)
        run = record(inputs, 2 ** 31 + 22, (64, 36), small=False)
    else:
        run, inputs = glass_run
    got = found(run, compare.reference_outputs(inputs, run, "cpu"))
    assert within(got, GLASS_BOUNDS), got


@pytest.mark.parametrize("scene_seed", [42, 1, 2, 3])
def test_random_balls_matches(scene_seed, monkeypatch):
    """Every pixel of the frame, so that the share does not swing with
    which 256 pixels a run's seed draws: 0.0108-0.0162 over the scenes of
    seeds 42 and 1-7, where glass shaded as diffuse reads 0.111 and the
    bfloat16 control 0.978 (the program's reassociated sphere test parts
    from the exact one on paths that leave a small sphere)."""
    inputs = random_balls(scene_seed)
    assert 484 <= len(inputs["spheres"]) <= 486
    run = record(inputs, 2 ** 31 + 23, (48, 27), small=True,
                 monkeypatch=monkeypatch)
    assert len(run["pixels"]) == 48 * 27
    got = found(run, compare.reference_outputs(inputs, run, "cpu"))
    assert within(got, SPONZA_BOUNDS), got


def test_glass_as_diffuse_is_not_correct(glass_run, monkeypatch):
    run, inputs = glass_run
    monkeypatch.setattr(ref_scene, "_is_glass", lambda m: False)
    got = found(run, compare.reference_outputs(inputs, run, "cpu"))
    assert not within(got, GLASS_BOUNDS), got


def test_the_control_is_not_correct_on_glass(glass_run):
    run, inputs = glass_run
    ref = compare.reference_outputs(inputs, run, "cpu")
    ctl = compare.reference_outputs(inputs, run, "cpu", torch.bfloat16)
    got = compare.numbers(ctl["values"], ref["values"], ctl["segments"],
                          ref["segments"])
    assert not within(got, GLASS_BOUNDS), got


def test_the_sphere_count_is_the_programs():
    """The reference takes float64 from the sphere count at which the
    program's dense test is reassociated; the two constants move
    together."""
    from ray_tracer_2_tpu_torch.kernels import intersect
    assert ref_scene.SPHERE_FAST_MIN == intersect.SPHERE_FAST_MIN


@pytest.mark.parametrize("material", [
    dict(normal_texture="wall"), dict(flag=3), dict(glass=True),
    dict(texture="no_such_image")],
    ids=["normal_texture", "unknown_flag", "old_glass_key", "missing_image"])
def test_a_material_the_reference_does_not_follow_raises(material):
    inputs = glass_scene()
    inputs["spheres"][0]["material"] = material
    with pytest.raises(ValueError):
        RefScene(inputs, "cpu")
