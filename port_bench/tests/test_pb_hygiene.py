"""Import hygiene: the harness, its readers and the reference load neither
JAX nor the JAX package, and the reference loads nothing of the port.
Module names are compared by their whole top-level name: the port's name
begins with the JAX package's."""

import ast
import glob
import json
import os
import subprocess
import sys

import pytest

from port_bench import harness

HOME = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX = {"jax", "jaxlib", "flax", "parfastaai_tpu"}
PORT = "parfastaai_tpu_torch"


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources():
    return [p for p in glob.glob(os.path.join(HOME, "**", "*.py"),
                                 recursive=True)
            if os.sep + "tests" + os.sep not in p]


def test_sources_import_no_jax():
    assert sources()
    for path in sources():
        assert not top_level_imports(path) & JAX, path


def test_reference_imports_nothing_of_the_port():
    names = top_level_imports(os.path.join(HOME, "reference.py"))
    assert PORT not in names and not names & JAX


def loaded_after(code):
    """Top-level names of the modules loaded in a fresh process after
    ``code``."""
    probe = code + (
        "\nimport json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", probe], cwd=os.path.dirname(
        HOME), capture_output=True, text=True, timeout=300,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_reference_loads_no_port_and_no_jax():
    loaded = loaded_after("import port_bench.reference")
    assert "torch" in loaded
    assert not loaded & (JAX | {PORT})


def test_a_run_loads_no_jax():
    code = (
        "import os\n"
        "from port_bench.tests.pb_tiny import tiny_cell\n"
        "from port_bench import harness\n"
        "r = harness.run_cell(tiny_cell('qdb-q256-t4096-exact'), 5, 0.2,"
        " True, device='cpu', log=open(os.devnull, 'w'))\n"
        "assert r['correct'], r\n"
        "assert harness.jax_modules() == []\n")
    loaded = loaded_after(code)
    assert PORT in loaded
    assert not loaded & JAX


def test_jax_modules_compares_whole_names(monkeypatch):
    before = set(harness.jax_modules())
    for name in ("parfastaai_tpu_torch.x", "parfastaai_tpux", "jaxtyping"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.jax_modules()) == before
    for name in ("jax.numpy", "parfastaai_tpu.engine"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert set(harness.jax_modules()) - before == {
        "jax.numpy", "parfastaai_tpu.engine"}


@pytest.mark.parametrize("missing", ["cuda", "program"])
def test_run_refuses_without_a_card_or_the_program(tmp_path, missing):
    """No CUDA, or a directory with only BENCHMARK.json and the
    benchmark's folder: a non-zero exit and no result line."""
    root = os.path.dirname(HOME)
    cwd = root
    if missing == "program":
        import shutil

        cwd = str(tmp_path)
        shutil.copy(os.path.join(root, "BENCHMARK.json"), cwd)
        shutil.copytree(HOME, os.path.join(cwd, "port_bench"),
                        ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "port_bench/run.py", "--workload",
         "avsa-g4096-exact", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=cwd, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0
    assert '"correct"' not in out.stdout
    assert ("parfastaai_tpu_torch" if missing == "program" else "no CUDA"
            ) in out.stderr
