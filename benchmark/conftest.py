"""What the shared tests of ``benchmark/tests`` need of a cell whose coder
is not the fast codecs' grid (``benchmark/coders/``), read for every
selection of them (``benchmark/pytest.ini`` roots them here): the cell's
tiny widths, and where ``test_bench_faults.py``'s faults land in its
program.

Those tests plant their faults in ``HESICFastCodec._decode_device`` (a
decode's outputs) and in ``_gmm_freq_fast`` (the rows' scales).  In a
cell on the wavefront coder the fixture below routes HESIC+'s own points,
``HESICPlusDeviceCodec._decode_device`` and ``wavefront.freq_rows``,
through those names, so that each fault the test plants there reaches
that cell's decoder and its rows."""

import pytest

from benchmark import run
from benchmark.tests import tiny

tiny.WIDTHS.setdefault("hesicplus-n128-m192", {"N": 16, "M": 24})


def _wavefront_points(monkeypatch):
    from hesic_tpu_torch.models import dsic_fast, hesic_fast, wavefront
    from hesic_tpu_torch.models.ar_device import HESICPlusDeviceCodec
    from hesic_tpu_torch.models.hesic_fast import HESICFastCodec
    grid_decode = HESICFastCodec._decode_device
    own_decode = HESICPlusDeviceCodec._decode_device
    grid_rows = hesic_fast._gmm_freq_fast
    own_rows = wavefront.freq_rows

    def decode(self, *a, **k):
        if isinstance(self, HESICPlusDeviceCodec):
            return own_decode(self, *a, **k)
        return grid_decode(self, *a, **k)

    def rows(sigma, *a, own=False, **k):
        return (own_rows if own else grid_rows)(sigma, *a, **k)

    monkeypatch.setattr(HESICFastCodec, "_decode_device", decode)
    monkeypatch.setattr(
        HESICPlusDeviceCodec, "_decode_device",
        lambda self, *a, **k: HESICFastCodec._decode_device(self, *a, **k))
    for mod in (hesic_fast, dsic_fast):
        monkeypatch.setattr(mod, "_gmm_freq_fast", rows)
    monkeypatch.setattr(wavefront, "freq_rows", lambda scales, mm:
                        hesic_fast._gmm_freq_fast(scales, mm, own=True))


FAULT_POINTS = {"wavefront": _wavefront_points}


@pytest.fixture(autouse=True)
def coder_fault_points(request, monkeypatch):
    """In test_bench_faults.py, a cell's coder's own fault points."""
    params = getattr(getattr(request.node, "callspec", None), "params", {})
    if request.module.__name__.rpartition(".")[2] != "test_bench_faults" \
            or "cell" not in params:
        return
    coder = run.cell(params["cell"][0])["config"].get("coder", "grid")
    if coder in FAULT_POINTS:
        FAULT_POINTS[coder](monkeypatch)
