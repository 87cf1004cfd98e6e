"""No module of the benchmark imports JAX, flax or the JAX package, and the
reference imports nothing of the program. Top-level module names are
compared whole: ``synapta_tpu_torch`` begins with ``synapta_tpu`` and is not
it."""
import ast
import glob
import os
import subprocess
import sys

import pytest

from portbench import harness

PB = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPO = os.path.dirname(PB)
FORBIDDEN = {"jax", "jaxlib", "flax", "synapta_tpu"}


def imported_roots(path):
    """Top-level names of every module a file imports (absolute imports)."""
    tree = ast.parse(open(path).read(), path)
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_file_imports_jax_or_the_jax_package():
    files = glob.glob(os.path.join(PB, "**", "*.py"), recursive=True)
    assert len(files) > 20
    for f in files:
        assert not imported_roots(f) & FORBIDDEN, f


def test_the_reference_imports_nothing_of_the_program():
    for f in glob.glob(os.path.join(PB, "reference", "*.py")):
        roots = imported_roots(f)
        assert "synapta_tpu_torch" not in roots and not roots & FORBIDDEN, f


def test_loading_the_reference_loads_no_program_module():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import portbench.reference.features, portbench.reference.models, "
            "portbench.reference.text\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'synapta_tpu_torch', 'synapta_tpu', 'jax', 'flax', 'jaxlib'}))" % REPO)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True).stdout.strip()
    assert out == "[]"


@pytest.mark.parametrize("loaded,found", [
    (["synapta_tpu_torch.ops.cc", "numpy"], []),
    (["synapta_tpu.ops", "synapta_tpu_torch"], ["synapta_tpu"]),
    (["jaxlib.xla_client", "jax_foo"], ["jaxlib"]),
    (["flax"], ["flax"]),
])
def test_the_run_time_check_compares_whole_names(monkeypatch, loaded, found):
    fake = {m: None for m in loaded}
    monkeypatch.setattr(sys, "modules", fake)
    assert harness.forbidden_modules() == found
