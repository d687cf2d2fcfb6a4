"""Nothing the benchmark runs loads JAX or the JAX package: a static walk
of benchmark/'s sources and a run in a fresh interpreter, both comparing
each module's whole top-level name (the port's name begins with the JAX
package's). The reference imports nothing of the program. Without a card
run.py exits non-zero and prints no result."""
import ast
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run

HERE = Path(__file__).resolve().parents[1]


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(
    p for p in HERE.rglob("*.py") if "tests" not in p.parts),
    ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    assert not _imports(path) & set(run.FORBIDDEN)


def test_reference_is_independent():
    paths = [*(HERE / "reference").glob("*.py"),
             *(HERE / "traffic").rglob("*.py")]
    assert HERE / "traffic" / "signals" / "c4fm.py" in paths
    for path in paths:
        assert "sdrtrunk_tpu_torch" not in _imports(path), path


def test_fresh_interpreter_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "import torch; torch.set_num_threads(1)\n"
        "from benchmark.tests import tiny\n"
        "from benchmark import run\n"
        "res = tiny.measure(tiny.spec('c4fm_bank_1023', slots=6, blocks=400))\n"
        "print(res['correct'], ','.join(run.forbidden_modules()) or '-')\n"
        % str(HERE.parent))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=600, cwd=HERE.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[-2:] == ["True", "-"], out.stdout


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, str(HERE / "run.py"), "--workload",
         "c4fm_bank_1023", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300,
        env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin",
             "HOME": str(HERE.parent / ".scratch")})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
