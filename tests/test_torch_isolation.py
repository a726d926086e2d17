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


def test_every_arch_config_is_scanned():
    """The scans above cover each config of ``ARCH_IDS`` (all ten of the
    reference's) and the MoE layer's module: each is a module of the
    package, imported in the
    fresh interpreter and parsed for imports, and none of them pulls in
    jax or the reference."""
    code = (
        "import json, sys\n"
        "from repro_torch.models import ARCH_IDS, load_config\n"
        "from repro_torch.models.layers import moe\n"
        "cfgs = [load_config(a).name for a in ARCH_IDS]\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps([list(ARCH_IDS), bad]))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, cwd=str(ROOT))
    archs, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert bad == [] and len(archs) == 10
    scanned = set(_modules())
    assert {f"repro_torch.configs.{a}" for a in archs} <= scanned
    assert "repro_torch.models.layers" in scanned


def test_training_modules_are_scanned():
    """The training path's modules (optimizer, train step and loop,
    checkpoints, data pipeline, launcher, tree helpers) are modules of
    the package, so the two scans above cover them, and importing them
    in a fresh interpreter loads no jax or reference module."""
    mods = ["repro_torch.optim.adamw", "repro_torch.train.step",
            "repro_torch.train.loop", "repro_torch.ckpt.checkpoint",
            "repro_torch.data.pipeline", "repro_torch.launch.train",
            "repro_torch.tree"]
    assert set(mods) <= set(_modules())
    code = (
        "import importlib, json, sys\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'repro', 'triton'))\n"
        "print(json.dumps(bad))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True, cwd=str(ROOT))
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
