"""Device times of the port's render kernels at 1920x1080 and of the
brute-force kernel, for comparing source trees in one run on one card.

    python3 -m ray_tracer_2_tpu_torch.kernel_times [TREE ...] \\
        [--order ABBA] [--reps 20] [--only REGEX] [--out FILE]

Each TREE is the root of a checkout of this repository (default: the one
this module lies in); the first is A, the second B. ``--order`` lists the
runs by letter, so two trees measured as "ABBA" run A, B, B, A. Each run is
a fresh process that imports the tree's own package, builds its kernels
(printing ``ptxas`` registers, stack and spills, and a digest of each
kernel's SASS: the last lines say, kernel by kernel, whether the trees
compiled it to the same instructions), builds the scenes and
times every cell: one warm-up launch, then ``--reps`` launches of frames 0,
1, ... between two CUDA events. A cell is a scene at a bounce count:

* the megakernel on ``main_path_scene`` and ``room2_scene`` at bounces 0-5
  and ``instances_scene`` at bounces 5;
* the small-scene kernel on ``random_balls`` and ``room`` at bounces 0-5;
* the prepass share: ``room2_scene`` and ``instances_scene`` at bounces 5
  once more with every triangle of every brute-force group of 128
  triangles or fewer listed twice (scene ``...-doubleprepass``). The copy
  of a triangle ties with it and the lower index keeps a tie, so every
  path, the image and the segment count stay what they were and only the
  prepass loop's work doubles: the time added is what the loop costs in a
  frame;
* sphere-heavy scenes at bounces 5 (a scene name is a scene of
  ``scenes.py`` or of ``_SCENES`` below, then ``+flags``: ``+aa``
  antialias, ``+nee`` next-event estimation, ``+bvh`` the sphere BVH
  forced, ``+global`` the megakernel's tables decided with a shared-memory
  budget of nothing, so that they are read from global memory):
  ``random_balls`` (485 spheres) through the megakernel with the dense
  loop and with the sphere BVH; ``random_balls22`` (about
  1,940 spheres, the most the dense paths take with room to spare) through
  the small-scene kernel, the megakernel's dense loop (staged and from
  global memory) and the sphere BVH; ``random_balls24`` (2,305 spheres: the
  sphere BVH by its size);
* the routing caps: ``random_balls`` without antialias and meshes of 16,
  32 and 64 triangles (``tris16``, ``tris32``, ``tris64``: the most the
  small-scene kernel takes) through both render kernels, and a 72-triangle
  mesh (``tris72``) through the megakernel;
* tables past the shared-memory budget: ``groups5`` (five 256-triangle
  brute-force groups, read from global memory) against ``groups4``
  (staged), and ``groups4+global``;
* next-event estimation (flag ``+nee``): ``room2_scene+nee`` (shadow
  segments), ``room+nee`` (the shadow ray tested inline) and
  ``sunlit_balls+bvh+nee`` (shadow segments through the sphere BVH) at
  bounces 5, beside the same scenes without it; a tree without NEE skips
  them;
* scenes from asset files and textures at bounces 5 (a tree without them
  skips them): ``sponza`` and ``bugatti`` through their procedural
  substitutes, with and without NEE; ``textured_atrium`` (the atrium's
  ten parts textured from a 168 MB atlas of seeded 1024 x 1024 images,
  ``scenes.textured_atrium_scene``), with and without NEE, beside
  ``sponza``'s untextured forms on the same geometry; ``texture_sphere``
  (``texture_test`` pulled back, a 512 x 256 image) and ``normal_map+nm``
  (the normal-map quad, flag ``+nm``: normal maps on); ``flat_atrium`` and
  ``flat_atrium_untextured`` (``_flat_atrium``: the same paths with and
  without texture taps), with and without NEE;
* ``main_path_scene`` and ``room2_scene`` at bounces 5 through
  ``Renderer.render`` (kernel ``renderer``: routing, blend and segment
  count included; the renderer's default mesh, none on one card), and the
  debug kernel in mode 1 on ``main_path_scene`` (kernel ``debug``);
* the standalone brute-force kernel on 2,073,600 seeded rays x 256
  triangles (kernel ``brute``), and on the first 256, 512 and all 600
  triangles of a 600-triangle table (three staged chunks): what staging a
  chunk between two loops costs;
* the ``mxu_leaf_dense`` probe kernel at the script's sizes (1024 rays, T =
  128 and 512, 64 steps), float32, bfloat16 and the tensor-core form:
  kernel-only time (``probes.common.graph_ms``: the calls captured into a
  CUDA graph and replayed), since one call is a few tens of microseconds
  and the host's dispatch would otherwise be what is read. A tree from
  before the probes had ``graph_ms`` gives no such cells.

Where the tree's kernels count their lane loop (``turns``,
``active_lanes``), each cell also gives lane occupancy, over the timed
launches. A cell that a tree cannot run (an older tree without the scene,
the option or the path) is reported as skipped with the reason.
``--only`` keeps the cells whose "kernel scene" matches. Every result is
one JSON line on standard output (and in ``--out``); the last lines are a
summary per cell and per kernel's SASS. Needs one CUDA card.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

W, H = 1920, 1080
BOUNCES = range(6)
# the worker: import the package of the tree given as argv[1]
_BOOT = ("import sys; sys.path.insert(0, sys.argv[1]); "
         "import runpy; runpy.run_path(sys.argv[2], run_name='__worker__')")


def _cells():
    for b in BOUNCES:
        yield "megakernel", "main_path_scene", b
    for b in BOUNCES:
        yield "megakernel", "room2_scene", b
    yield "megakernel", "instances_scene", 5
    yield "megakernel", "room2_scene-doubleprepass", 5
    yield "megakernel", "instances_scene-doubleprepass", 5
    for name in ("random_balls", "room"):
        for b in BOUNCES:
            yield "spheres", name, b
    for name in ("random_balls+aa", "random_balls+aa+bvh", "random_balls",
                 "random_balls+bvh", "random_balls22", "random_balls22+global",
                 "random_balls22+bvh", "random_balls24", "tris64", "tris72",
                 "groups4", "groups4+global", "groups5", "room", "balls",
                 "metal", "tris16", "tris32", "random_balls+global",
                 "instances_scene+global", "room2_scene+global", "groups1",
                 "groups1+global", "groups2", "groups2+global", "groups3",
                 "groups3+global"):
        yield "megakernel", name, 5
    for name in ("random_balls22", "tris64", "balls", "metal", "tris16",
                 "tris32"):
        yield "spheres", name, 5
    for name in ("random_balls", "room", "balls"):
        yield "megakernel", name, 0
    for name in ("room2_scene+nee", "room+nee", "sunlit_balls+bvh",
                 "sunlit_balls+bvh+nee"):
        yield "megakernel", name, 5
    for name in ("sponza", "sponza+nee", "bugatti", "bugatti+nee",
                 "textured_atrium", "textured_atrium+nee", "texture_sphere",
                 "normal_map", "normal_map+nm", "flat_atrium",
                 "flat_atrium_untextured", "flat_atrium+nee",
                 "flat_atrium_untextured+nee"):
        yield "megakernel", name, 5
    yield "spheres", "balls", 0
    # the main path and room2 through Renderer.render (its routing, blend
    # and segment sum included), and the debug kernel in mode 1
    for name in ("main_path_scene", "room2_scene"):
        yield "renderer", name, 5
    yield "debug", "main_path_scene", 0


class _ThroughRenderer:
    """Cells ``renderer``: frames through ``Renderer.render`` on the card
    (default mesh), one renderer per frame size."""

    counts = ()

    def __init__(self):
        self._renderers = {}

    def reset_counts(self) -> None:
        pass

    def __call__(self, scene, frames, *, bounces, width, height, **kw):
        from ray_tracer_2_tpu_torch.config import RenderParams
        from ray_tracer_2_tpu_torch.engine.renderer import Renderer
        r = self._renderers.setdefault((width, height),
                                       Renderer(device="cuda"))
        fb = r.render(scene, RenderParams(width=width, height=height,
                                          bounces=bounces, frames=frames,
                                          **kw))
        return fb, r.last_segments


class _Debug:
    """Cells ``debug``: one launch of the debug kernel in mode 1 (normals),
    the whole frame; it traces no path segments."""

    counts = ()

    def reset_counts(self) -> None:
        pass

    def __call__(self, scene, frames, *, bounces, width, height, **kw):
        import torch

        from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG
        img, _ = CUDA_DEBUG(scene, width=width, height=height, debug_mode=1,
                            debug_scale=100.0)
        return img, torch.zeros((), dtype=torch.int64, device=img.device)


# scenes of the cells that are not a plain name of scenes.py
_SCENES = {
    "random_balls22": lambda sc: sc.random_balls(half=22),
    "random_balls24": lambda sc: sc.random_balls(half=24),
    "tris16": lambda sc: sc.wide_bvh_scene(lat=2, lon=4),
    "tris32": lambda sc: sc.wide_bvh_scene(lat=4, lon=4),
    "tris64": lambda sc: sc.wide_bvh_scene(lat=4, lon=8),
    "tris72": lambda sc: sc.wide_bvh_scene(lat=4, lon=9),
    "groups1": lambda sc: sc.groups_scene(1),
    "groups2": lambda sc: sc.groups_scene(2),
    "groups3": lambda sc: sc.groups_scene(3),
    "groups4": lambda sc: sc.groups_scene(4),
    "groups5": lambda sc: sc.groups_scene(5),
}
# scenes that take the tree's asset manager (textures made in memory)
_TEX_SCENES = {
    "textured_atrium": lambda sc, a: sc.textured_atrium_scene(a),
    "texture_sphere": lambda sc, a: sc.texture_sphere_scene(a),
    "normal_map": lambda sc, a: sc.normal_map_scene(a),
    "flat_atrium": lambda sc, a: _flat_atrium(sc, a, textured=True),
    "flat_atrium_untextured": lambda sc, a: _flat_atrium(sc, a,
                                                         textured=False),
}
#: the flat atrium's colour, a byte: 179 / 255 = 0.702 (sponza's parts 0.7)
FLAT = 179


def _flat_atrium(sc, assets, textured: bool):
    """``textured_atrium_scene``'s parts, lights and camera with one colour,
    ``FLAT`` / 255, in every part: through textures of 1024 x 1024 texels
    of that colour (an atlas as large as ``textured_atrium``'s, read at the
    same addresses) or, untextured, as the material's colour. A constant
    image samples to that colour within an ulp, so the two trace the same
    paths to within a few segments: what they differ by is the taps' cost."""
    import dataclasses

    import numpy as np

    from ray_tracer_2_tpu_torch.assets.manager import AssetManager
    c = float(np.float32(FLAT) / np.float32(255.0))
    img = np.full((1024, 1024, 4), c, np.float32)
    img[..., 3] = 1.0
    definition = sc.textured_atrium_scene(AssetManager(), size=1)
    for e in definition.entities:
        m = e.material
        if m.diffuse_texture is None:
            continue
        if textured:
            assets.add_texture(m.diffuse_texture, img)
        e.material = dataclasses.replace(
            m, color=(c, c, c, 1.0),
            **({} if textured else dict(diffuse_texture=None)))
    return definition


def _build_scene(name: str):
    """The cell's scene on the card and its render options. Raises
    ``TypeError``/``AttributeError``/``ImportError``/``NotImplementedError``
    where the imported tree lacks the scene or the option."""
    from ray_tracer_2_tpu_torch.kernels.megakernel import kernel_tables
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
    base, *flags = name.split("+")
    base, _, doubled = base.partition("-")
    kw = dict(sphere_bvh=True) if "bvh" in flags else {}
    if base in _TEX_SCENES:
        from ray_tracer_2_tpu_torch.assets.manager import AssetManager
        kw["assets"] = AssetManager()
        definition = _TEX_SCENES[base](scenes, kw["assets"])
    else:
        definition = _SCENES[base](scenes) if base in _SCENES \
            else getattr(scenes, base)()
    if doubled:
        definition = _doubled_groups(definition)
    scene = instantiate_scene(definition, **kw).to("cuda")
    if "global" in flags and kernel_tables(scene, budget=0)["staged"]:
        raise NotImplementedError("tables are always staged")
    over = dict(antialias=True) if "aa" in flags else {}
    if "nee" in flags:
        over["nee"] = True
    if "nm" in flags:
        over["normal_maps"] = True
    return scene, over


def _brute_inputs():
    """The brute check's inputs (as ``chip_smoke.py``): one ray per 1080p
    pixel from a seed, a table of 256 triangles of mixed cull and one of
    600 triangles."""
    import numpy as np
    import torch

    from ray_tracer_2_tpu_torch.kernels.brute import pack_brute_table
    from ray_tracer_2_tpu_torch.math.transform import Transform
    from ray_tracer_2_tpu_torch.scene import scenes
    from ray_tracer_2_tpu_torch.scene.definition import (
        MeshFromData, SceneDefinition,
    )
    from ray_tracer_2_tpu_torch.scene.material import MaterialDefinition
    from ray_tracer_2_tpu_torch.scene.render_scene import instantiate_scene
    s = SceneDefinition()
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(8, 8, 1.0)),
               MaterialDefinition.new())
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(8, 8, 0.5)),
               MaterialDefinition.new().glass(1.5))
    scene = instantiate_scene(s).to("cuda")
    _, tri_off, count = scene.inst_spans[0]
    s = SceneDefinition()
    s.add_mesh(Transform(), MeshFromData(scenes.latlon_soup(15, 20, 1.0)),
               MaterialDefinition.new())
    big = instantiate_scene(s).to("cuda")
    rng = np.random.default_rng(0)
    o = rng.uniform(-1.5, 1.5, (W * H, 3)).astype(np.float32)
    d = rng.normal(size=(W * H, 3))
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    rays = torch.from_numpy(np.concatenate(
        [o, d, np.zeros((W * H, 2), np.float32)], axis=1)).cuda()
    return (rays, pack_brute_table(scene, tri_off, count),
            pack_brute_table(big, 0, 600))


def _doubled_groups(definition):
    """``definition`` with the triangles of every mesh of 128 triangles or
    fewer (a brute-force group, still one when doubled) listed twice;
    entities that share a mesh go on sharing it."""
    import numpy as np

    from ray_tracer_2_tpu_torch.scene.definition import MeshData, \
        MeshFromData
    doubled = {}
    for e in definition.entities:
        p = e.primitive
        if not isinstance(p, MeshFromData) \
                or p.resolved().triangle_count() > 128:
            continue
        if id(p) not in doubled:
            m = p.resolved()
            doubled[id(p)] = MeshFromData(MeshData(
                m.positions, m.normals, m.uvs,
                np.concatenate([m.indices, m.indices])))
        e.primitive = doubled[id(p)]
    return definition


def _worker(tree: str, label: str, reps: int, only: str) -> None:
    import re

    import torch

    import ray_tracer_2_tpu_torch as pkg
    from ray_tracer_2_tpu_torch.kernels.brute import CUDA_BRUTE
    from ray_tracer_2_tpu_torch.kernels.cuda_build import build_all
    from ray_tracer_2_tpu_torch.kernels.megakernel import CUDA_MEGAKERNEL
    from ray_tracer_2_tpu_torch.kernels.spheres import CUDA_SPHERES

    def emit(**obj):
        print(json.dumps(dict(run=label, **obj)), flush=True)

    here = Path(pkg.__file__).resolve().parents[1]
    if here != Path(tree).resolve():
        raise RuntimeError(f"imported the package of {here}, not {tree}")
    from ray_tracer_2_tpu_torch.kernels.debug import CUDA_DEBUG
    kernels = dict(megakernel=CUDA_MEGAKERNEL, spheres=CUDA_SPHERES)
    build_all(*kernels.values(), CUDA_BRUTE, CUDA_DEBUG)
    for name, k in dict(kernels, brute=CUDA_BRUTE, debug=CUDA_DEBUG).items():
        emit(phase="build", kernel=name, ptxas=[
            ln.strip() for ln in k.build_log.splitlines()
            if any(w in ln for w in ("entry function", "registers", "spill"))],
            sass=_sass_digests(k.source))
    kernels.update(renderer=_ThroughRenderer(), debug=_Debug())
    built = {}
    kw0 = dict(width=W, height=H, rays_per_pixel=1, skybox=True)
    for kname, sname, b in _cells():
        if not re.search(only, f"{kname} {sname}"):
            continue
        k = kernels[kname]
        try:
            if sname not in built:
                built[sname] = _build_scene(sname)
            scene, over = built[sname]
            kw = dict(kw0, **over)
            k(scene, 0, bounces=b, **kw)
        except (TypeError, AttributeError, KeyError, ImportError,
                NotImplementedError) as e:
            emit(phase="skipped", kernel=kname, scene=sname, bounces=b,
                 reason=f"{type(e).__name__}: {e}"[:200])
            continue
        torch.cuda.synchronize()
        k.reset_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        segs = [k(scene, f, bounces=b, **kw)[1] for f in range(reps)]
        end.record()
        torch.cuda.synchronize()
        c = k.read_counts() if "turns" in getattr(k, "counts", ()) else {}
        seg = sum(int(s) for s in segs)
        r = dict(phase="cell", kernel=kname, scene=sname, bounces=b,
                 ms=start.elapsed_time(end) / reps,
                 segments_per_pixel=seg / (reps * W * H))
        if c:
            r["lane_occupancy"] = c["active_lanes"] / (32.0 * c["turns"])
            for key in ("rows", "leaves", "boxes"):
                if key in c:
                    r[f"{key}_per_segment"] = c[key] / seg
            if c.get("shadow_rays"):
                r["shadow_share"] = c["shadow_rays"] / seg
        emit(**r)
    if re.search(only, "brute"):
        _brute_cells(emit, reps)
    if re.search(only, "mxu_leaf_dense"):
        _mxu_cells(emit)


def _sass_digests(source: Path) -> dict:
    """Per kernel of ``source``'s built library, by ``_kernel_name``: the
    first 16 hex digits of the SHA-256 of its SASS (``cuobjdump -sass``),
    so that two trees' forms can be called instruction for instruction the
    same or not."""
    import hashlib
    import re

    from ray_tracer_2_tpu_torch.kernels import cuda_build as cb
    lib = cb.load_library(source)[0]._name
    sass = subprocess.run(
        [str(Path(cb._find_nvcc()).with_name("cuobjdump")), "-sass", lib],
        capture_output=True, text=True, check=True).stdout
    funcs, name = {}, None
    for ln in sass.splitlines():
        m = re.match(r"\s*Function : (\w+)", ln)
        if m:
            name = cb._kernel_name(m.group(1))
            funcs[name] = []
        elif name is not None:
            funcs[name].append(ln.strip())
    return {n: hashlib.sha256("\n".join(v).encode()).hexdigest()[:16]
            for n, v in funcs.items()}


def _brute_cells(emit, reps: int) -> None:
    import torch

    from ray_tracer_2_tpu_torch.kernels.brute import CUDA_BRUTE
    rays, table, big = _brute_inputs()
    for tab, n in ((table, 256), (big, 256), (big, 512), (big, 600)):
        CUDA_BRUTE(rays, tab, n)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            CUDA_BRUTE(rays, tab, n)
        end.record()
        torch.cuda.synchronize()
        emit(phase="cell", kernel="brute",
             scene=f"2073600 rays x {n} of {tab.shape[0]} tris",
             bounces=0, ms=start.elapsed_time(end) / reps)


def _mxu_cells(emit) -> None:
    import numpy as np
    import torch

    try:
        from ray_tracer_2_tpu_torch.probes.common import graph_ms
    except ImportError:     # a tree from before the probes had it
        return
    from ray_tracer_2_tpu_torch.probes.lut import mxu_leaf_dense
    dev = torch.device("cuda", 0)
    for dt in (torch.float32, torch.bfloat16):
        for T in (128, 512):
            rng = np.random.default_rng(0)
            rays = torch.from_numpy(rng.random((1024, 16))
                                    .astype(np.float32)).to(dev).to(dt)
            tris = torch.from_numpy(rng.random((16, T))
                                    .astype(np.float32)).to(dev).to(dt)
            for form in ("simt", "mma") if dt == torch.bfloat16 \
                    else ("simt",):
                ms = graph_ms(lambda: mxu_leaf_dense(rays, tris, steps=64,
                                                     form=form), dev)
                emit(phase="cell", kernel="mxu_leaf_dense",
                     scene=f"{str(dt).split('.')[-1]} T={T} {form}",
                     bounces=64, ms=ms)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("trees", nargs="*",
                    default=[str(Path(__file__).resolve().parents[1])])
    ap.add_argument("--order", default=None,
                    help="runs by tree letter, e.g. ABBA (default: each "
                         "tree once)")
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--only", default="",
                    help="regular expression: keep the cells whose "
                         "'kernel scene' it matches (brute and "
                         "mxu_leaf_dense by those words)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--timeout", type=float, default=600.0)
    args = ap.parse_args(argv)
    letters = "ABCDEFGH"[:len(args.trees)]
    order = args.order or letters
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi, flush=True)
    lines = [dict(phase="device", nvidia_smi=smi,
                  trees=dict(zip(letters, args.trees)), order=order)]
    out = open(args.out, "w") if args.out else None
    for i, letter in enumerate(order):
        tree = args.trees[letters.index(letter)]
        label = f"{letter}{i}"
        res = subprocess.run(
            [sys.executable, "-c", _BOOT, str(Path(tree).resolve()),
             str(Path(__file__).resolve()), label, str(args.reps),
             args.only],
            capture_output=True, text=True, timeout=args.timeout)
        if res.returncode != 0:
            sys.stderr.write(res.stdout[-4000:] + res.stderr[-4000:])
            raise RuntimeError(f"run {label} on {tree} failed")
        for ln in res.stdout.splitlines():
            if ln.startswith("{"):
                lines.append(json.loads(ln))
    summary = {}
    for r in lines:
        if r.get("phase") == "cell":
            key = f"{r['kernel']} {r['scene']} b{r['bounces']}"
            summary.setdefault(key, {}).setdefault(r["run"][0], []).append(
                r["ms"])
    lines += [dict(phase="summary", cell=k, ms=v) for k, v in summary.items()]
    sass = {}
    for r in lines:
        for fn, digest in r.get("sass", {}).items():
            sass.setdefault(f"{r['kernel']} {fn}", {})[r["run"][0]] = digest
    lines += [dict(phase="sass", kernel=k, digests=v,
                   identical=len(v) == len(letters)
                   and len(set(v.values())) == 1)
              for k, v in sass.items()]
    for r in lines:
        print(json.dumps(r), flush=True)
        if out:
            out.write(json.dumps(r) + "\n")
    if out:
        out.close()
    return 0


if __name__ == "__worker__":
    _worker(sys.argv[1], sys.argv[3], int(sys.argv[4]), sys.argv[5])
elif __name__ == "__main__":
    sys.exit(main())
