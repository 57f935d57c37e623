"""No module of the benchmark imports JAX or the JAX package, and the
plain reference imports nothing of the program under test."""

import ast
import subprocess
import sys
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
BANNED = {"jax", "jaxlib", "flax", "pint_tpu"}


def imported(path: Path) -> set:
    """Every module name a file imports, statically or by a string given to
    ``importlib.import_module`` / ``__import__``."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module)
        elif (isinstance(node, ast.Call) and node.args
              and isinstance(node.args[0], ast.Constant) and isinstance(node.args[0].value, str)
              and getattr(node.func, "attr", getattr(node.func, "id", "")) in
              ("import_module", "__import__")):
            names.add(node.args[0].value)
    return names


def top(name: str) -> str:
    return name.split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    found = {str(p.relative_to(ROOT)): sorted(n for n in imported(p) if top(n) in BANNED)
             for p in files}
    assert not {k: v for k, v in found.items() if v}


def test_the_port_is_not_the_jax_package():
    """The top-level name is compared whole: the port's name begins with
    the JAX package's."""
    assert top("pint_tpu_torch.serving") not in BANNED
    assert top("pint_tpu.serving") in BANNED


def test_the_reference_imports_nothing_of_the_program():
    for p in sorted((BENCH / "reference").glob("*.py")):
        for n in imported(p):
            assert top(n) in {"__future__", "numpy", "torch", "portbench"}, (p, n)
            if top(n) == "portbench":
                assert n.startswith("portbench.reference"), (p, n)


def test_loading_the_reference_loads_nothing_of_the_program():
    code = ("import sys; import portbench.reference.rti, portbench.reference.crti; "
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('pint_tpu_torch', 'pint_tpu', 'jax', 'jaxlib', 'flax')); print(bad); "
            "sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
