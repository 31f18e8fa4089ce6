"""No module of the benchmark imports jax, jaxlib, flax or the JAX
package (top-level names compared whole: hesic_tpu_torch is not
hesic_tpu), and the references, the judge and the coders import nothing
of the program either."""

import ast
import os

import pytest

from benchmark import run

FILES = sorted(os.path.relpath(os.path.join(d, f), run.ROOT)
               for d, _, fs in os.walk(run.HERE) for f in fs
               if f.endswith(".py"))


def tops(rel):
    tree = ast.parse(open(os.path.join(run.ROOT, rel)).read())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
    return out


@pytest.mark.parametrize("rel", FILES)
def test_no_forbidden_import(rel):
    found = tops(rel)
    assert not found & set(run.FORBIDDEN), found
    if rel.startswith(("benchmark/reference/", "benchmark/judge.py",
                       "benchmark/pairs.py", "benchmark/weights.py",
                       "benchmark/peaks.py", "benchmark/metrics/",
                       "benchmark/coders/", "benchmark/container.py")):
        assert "hesic_tpu_torch" not in found


def test_program_is_named_by_configuration_only():
    for c in ("hesic-n128-m192", "dsic-n128-m192"):
        prog = run.read_json(f"benchmark/configs/{c}.json")["program"]
        assert all(v.startswith("hesic_tpu_torch.") for v in prog.values())


def test_forbidden_names_compared_whole():
    assert run.forbidden_modules(["hesic_tpu_torch.models", "numpy",
                                  "jaxtyping"]) == []
    assert run.forbidden_modules(["hesic_tpu.models.hesic", "flax.linen",
                                  "jax"]) == ["flax", "hesic_tpu", "jax"]
