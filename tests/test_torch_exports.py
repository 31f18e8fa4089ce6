"""Port: every package of hesic_tpu_torch exports the public names of its
JAX counterpart (ROADMAP C10).

Each ``hesic_tpu/<sub>/__init__.py`` (and the top-level one) is read with
``ast``: the names its top level binds by ``from ... import``, ``def``,
``class`` or assignment, and its ``__all__``, less those starting with an
underscore.  Each must be an attribute of the port's package of the same
name, except the listed few, each with its reason.  The port is imported
in a subprocess, so that what a package exports does not depend on what
another test imported first.  About 5 s on the CPU.
"""

import ast
import json
import os
import pathlib
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_PKG = ROOT / "hesic_tpu"

# (package, name): why the port has no such name
LEFT_OUT = {
    ("layers", "Sequential"): "a flax helper; a PyTorch module holds its "
                              "own layers",
    ("layers", "conv"): "a flax helper; a PyTorch module holds its own "
                        "layers",
    ("layers", "deconv"): "a flax helper; a PyTorch module holds its own "
                          "layers",
    ("layers", "pixel_shuffle"): "a flax helper; a PyTorch module holds "
                                 "its own layers",
    ("layers", "kaiming_normal"): "a flax initializer; the port's layers "
                                  "draw their own init",
    ("training", "TrainState"): "the optimizer holds the state (ROADMAP "
                                "'Left out on purpose')",
}


def _public_names(path: pathlib.Path) -> set:
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom):
            names.update(a.asname or a.name for a in node.names)
        elif isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target])
            for t in targets:
                if isinstance(t, ast.Name):
                    names.add(t.id)
                    if t.id == "__all__":
                        names.update(ast.literal_eval(node.value))
    return {n for n in names if not n.startswith("_")}


PACKAGES = [""] + sorted(p.parent.name for p in JAX_PKG.glob("*/__init__.py"))


@pytest.fixture(scope="module")
def port_attributes():
    """{package: sorted attribute names} of every port package, read in
    one fresh interpreter."""
    code = (
        "import importlib, json\n"
        f"pkgs = {PACKAGES!r}\n"
        "out = {}\n"
        "for p in pkgs:\n"
        "    name = 'hesic_tpu_torch' + ('.' + p if p else '')\n"
        "    try:\n"
        "        out[p] = sorted(dir(importlib.import_module(name)))\n"
        "    except ImportError as e:\n"
        "        out[p] = 'ImportError: ' + str(e)\n"
        "print(json.dumps(out))\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=180)
    assert res.returncode == 0, res.stdout + res.stderr
    return json.loads(res.stdout.strip().splitlines()[-1])


def test_every_jax_package_is_listed():
    assert len(PACKAGES) >= 12, PACKAGES
    assert "parallel" in PACKAGES


@pytest.mark.parametrize("pkg", PACKAGES, ids=lambda p: p or "top")
def test_port_exports_the_jax_names(pkg, port_attributes):
    path = JAX_PKG / pkg / "__init__.py" if pkg else JAX_PKG / "__init__.py"
    want = _public_names(path)
    assert want, path
    left_out = {n for (p, n) in LEFT_OUT if p == pkg}
    assert left_out <= want, f"stale exceptions {left_out - want}"
    have = port_attributes[pkg]
    assert not isinstance(have, str), have
    missing = sorted(want - left_out - set(have))
    assert not missing, (f"hesic_tpu_torch{'.' + pkg if pkg else ''} lacks "
                         f"{missing}")
