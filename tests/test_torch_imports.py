"""The port stands alone: no module of ``repro_torch`` (nor ``chip_smoke.py``)
imports JAX or anything of the JAX package ``repro``."""

import ast
import pkgutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
FILES = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _modules():
    import repro_torch
    return ["repro_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                              "repro_torch."))


def test_every_module_imports_with_jax_and_repro_blocked():
    """Import every module of the port in a fresh interpreter in which
    ``import jax`` and ``import repro`` fail."""
    mods = _modules()
    assert len(mods) >= 20
    assert {"repro_torch.obs.trace", "repro_torch.obs.metrics",
            "repro_torch.obs.calibration",
            "repro_torch.launch.serve"} <= set(mods)
    code = textwrap.dedent(f"""
        import importlib, sys
        sys.modules["jax"] = None
        sys.modules["repro"] = None
        for name in {mods!r}:
            importlib.import_module(name)
        assert not any(m == "jax" or m.startswith(("jax.", "repro."))
                       for m, v in sys.modules.items() if v is not None)
        print("ok", len({mods!r}))
    """)
    env = {"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_file_names_jax_or_repro(path):
    """By the syntax tree: no import of ``jax``/``repro`` and no string that
    names a ``jax``/``repro.`` module to be imported dynamically."""
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        elif isinstance(node, ast.Constant) and isinstance(node.value, str):
            v = node.value
            if v == "jax" or v.startswith(("jax.", "repro.")) or v == "repro":
                names = [v]
        for n in names:
            top = n.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.relative_to(ROOT)}:{node.lineno} names {n!r}"
