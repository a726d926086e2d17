"""The port stands alone: ``repro_torch`` imports neither jax nor the JAX
package, and needs no triton."""
import ast
import json
import os
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "src" / "repro_torch"


def _modules():
    for p in sorted(PKG.rglob("*.py")):
        rel = p.relative_to(PKG.parent).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_import_leaves_jax_and_reference_out():
    """Importing the package and every submodule in a fresh interpreter
    loads no jax, jaxlib, repro or triton module."""
    code = (
        "import importlib, json, sys\n"
        f"for m in {list(_modules())!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, cwd=str(ROOT))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_sources_import_no_jax_or_reference():
    """A scan of every source file: no ``import jax`` and no import of the
    ``repro`` package (``repro_torch`` itself is fine)."""
    bad = []
    for p in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(p.read_text(), str(p))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                    bad.append(f"{p.relative_to(ROOT)}: {name}")
    assert bad == []
