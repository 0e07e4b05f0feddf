"""The configurations' sizes."""
from rtbench import manifest


def inputs(name):
    m = manifest.load()
    return manifest.builder(name).inputs(manifest.config(m, name), 0)


def triangles(meshes):
    return sum(len(mesh["pos"]) // 3 for mesh in meshes)


def test_sponza268k_is_the_real_models_size():
    s = inputs("sponza268k")
    atrium = [m for m in s["meshes"] if m["material"].get("texture")]
    assert len(atrium) == 10 and triangles(atrium) == 268_224
    assert triangles(s["meshes"]) == 268_224 + 2        # the quad light
    assert len(s["images"]) == 10
    texels = sum(im.shape[0] * im.shape[1] for im in s["images"].values())
    assert texels == 10_485_760
    # the program's atlas stores a texel and its three neighbours, 16 B
    assert texels * 16 == 167_772_160
    assert all(im.dtype.name == "uint8" for im in s["images"].values())
    assert len(s["spheres"]) == 1

