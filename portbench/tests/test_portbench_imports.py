"""The benchmark imports neither JAX nor the JAX package (compared by whole top-level module
name: ``diffsim_tpu_torch`` is the port, ``diffsim_tpu`` the JAX package), and its reference
imports nothing of the program."""

import ast
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
FORBIDDEN = {"jax", "jaxlib", "flax", "diffsim_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    for d, _, files in os.walk(os.path.join(HERE, sub)):
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_no_source_imports_jax_or_the_jax_package():
    bad = {p: m for p in _sources() for m in _imports(p) if m in FORBIDDEN}
    assert not bad


def test_the_reference_imports_nothing_of_the_program():
    bad = {p: m for p in _sources("reference") for m in _imports(p)
           if m in FORBIDDEN or m == "diffsim_tpu_torch"}
    assert not bad


def test_a_run_loads_no_jax():
    code = (
        "import sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import portbench.harness.cli, portbench.calibrate, portbench.sweep\n"
        "import diffsim_tpu_torch.metrics.diffsim_sd15, diffsim_tpu_torch.metrics.diffsim_xl\n"
        "import diffsim_tpu_torch.cli.serve, diffsim_tpu_torch.ops.kernels\n"
        "print(portbench.harness.cli.forbidden_modules())\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
