"""Port isolation: hesic_tpu_torch and chip_smoke.py import nothing of JAX
(jax, jaxlib, flax) and nothing of the JAX package hesic_tpu, and
chip_smoke.py refuses to run without a CUDA device."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PKG = ROOT / "hesic_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "hesic_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _sources():
    return sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT)
    env["CUDA_VISIBLE_DEVICES"] = ""
    return env


def test_importing_every_module_loads_no_jax():
    modules = [".".join(p.relative_to(ROOT).with_suffix("").parts)
               for p in sorted(PKG.rglob("*.py"))]
    modules = [m[: -len(".__init__")] if m.endswith(".__init__") else m
               for m in modules] + ["chip_smoke"]
    code = (
        "import importlib, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"bad = [m for m in sys.modules if any(m == f or m.startswith(f + '.')"
        f" for f in {FORBIDDEN!r})]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=_env(),
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert len(modules) >= 20


@pytest.mark.parametrize("path", _sources(), ids=lambda p: p.name)
def test_source_has_no_jax_import(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        assert not any(_forbidden(n) for n in names), (path, names)


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_a_card(tmp_path, alone):
    if alone:                      # a directory holding only the script
        shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
        cwd, env = tmp_path, {k: v for k, v in _env().items()
                              if k != "PYTHONPATH"}
    else:
        cwd, env = ROOT, _env()
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode != 0
    assert '"ok": true' not in res.stdout
