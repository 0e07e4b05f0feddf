"""The benchmark loads neither the JAX stack nor the JAX package, and the
reference loads nothing of the program."""
import ast
import subprocess
import sys

from rtbench import manifest

RTBENCH = manifest.ROOT / "rtbench"


def loaded_after(stmt: str) -> set:
    code = (f"import sys; {stmt}; "
            "print(' '.join(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=manifest.ROOT,
                         capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin", "JAX_PLATFORMS": "cpu"})
    return set(out.stdout.split())


def test_run_and_reference_load_no_jax():
    top = loaded_after("import rtbench.run, rtbench.reference.compare, "
                       "rtbench.harness")
    assert not top & {"jax", "jaxlib", "flax", "ray_tracer_2_tpu"}


def test_reference_loads_nothing_of_the_program():
    top = loaded_after("import rtbench.reference.compare, "
                       "rtbench.reference.tracer")
    assert not top & {"ray_tracer_2_tpu_torch", "ray_tracer_2_tpu", "jax"}


def test_no_file_names_jax_or_the_jax_package():
    bad = {"jax", "jaxlib", "flax", "ray_tracer_2_tpu"}
    for path in RTBENCH.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.module:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in bad, (path, n)
                if path.parent.name == "reference":
                    assert n.split(".")[0] != "ray_tracer_2_tpu_torch", path
