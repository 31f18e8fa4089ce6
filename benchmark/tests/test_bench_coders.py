"""The coder a configuration names is the one the run and the control
call: a stub supplied through the loader in place of the grid coder is
called, a stub whose container states every lane 2% longer than the
reference's coder fails the check, and an unknown name fails before the
program's set-up, naming the file it looked for."""

import types

import pytest

from benchmark import limits, run, weights
from benchmark.tests import tiny

HOOKS = ("build", "encoded", "quantise", "stated", "reference_bits",
         "control_stated", "work")
HESIC = "hesic.rig-batch64"


def stub(calls: list, **replace):
    """A coder that records each hook it is asked for and hands the call
    to the grid coder, or to `replace`'s function of that name."""
    grid = run.coder({})
    mod = types.ModuleType("stub_coder")
    for name in HOOKS:
        def hook(*a, _name=name, **k):
            calls.append(_name)
            return replace.get(_name, getattr(grid, _name))(*a, **k)
        setattr(mod, name, hook)
    return mod


def supply(monkeypatch, name, module):
    """`module` as ``benchmark/coders/<name>.py`` to the loader."""
    real = run.load_file

    def load(rel):
        return module if rel == f"benchmark/coders/{name}.py" else real(rel)

    monkeypatch.setattr(run, "load_file", load)


def named(workload, coder, limits_=None):
    over = tiny.override(workload)
    over["config"]["coder"] = coder
    if limits_:
        over["config"]["limits"] = dict(over["config"]["limits"], **limits_)
    return over


def test_named_coder_is_called(monkeypatch):
    calls = []
    supply(monkeypatch, "stub", stub(calls))
    over = named(HESIC, "stub")
    out = run.run_cell(tiny.args(HESIC, trace=1), device="cpu",
                       check_chip=False, override=over)
    assert out["correct"] is True
    assert set(calls) == set(HOOKS) - {"control_stated"}
    del calls[:]
    v = limits.control_checks(HESIC, 2 ** 31 + 77, device="cpu",
                              override=over)
    assert v["correct"] is False
    assert set(calls) == {"quantise", "control_stated", "reference_bits"}


def test_lanes_stated_long_are_not_correct(monkeypatch):
    """The container's lanes 2% longer than the reference's coder gives:
    the left eye's gap reads 2% against the HESIC cell's own limit."""
    cell_limit = run.cell(HESIC)["config"]["limits"]["rate_gap_left_pct"]
    assert cell_limit < 2.0
    keep = {"rate_gap_left_pct": cell_limit}
    supply(monkeypatch, "long", stub([], reference_bits=lambda ref, model,
                                     batch, d: d["bits"] / 1.02))
    runs = {}
    for coder in ("grid", "long"):
        runs[coder] = run.run_cell(tiny.args(HESIC), device="cpu",
                                   check_chip=False,
                                   override=named(HESIC, coder, keep))
    assert runs["grid"]["correct"] is True
    chk = runs["long"]["checks"]["rate_gap_left_pct"]
    assert chk["value"] == pytest.approx(2.0) and chk["limit"] == cell_limit
    assert runs["long"]["correct"] is False and runs["long"]["failed"] > 0


def test_unknown_coder_names_its_file(monkeypatch):
    with pytest.raises(FileNotFoundError, match="benchmark/coders/nope.py"):
        run.coder({"coder": "nope"})

    def no_set_up(*a, **k):
        raise AssertionError("the program's set-up began")

    monkeypatch.setattr(weights, "state", no_set_up)
    monkeypatch.setattr(run, "program_class", no_set_up)
    with pytest.raises(FileNotFoundError, match="benchmark/coders/nope.py"):
        run.run_cell(tiny.args(HESIC), device="cpu", check_chip=False,
                     override=named(HESIC, "nope"))
