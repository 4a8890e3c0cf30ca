"""The per-layer metrics read from the program's own spans and counters, on
the tiny CPU cells: the host and counter readings are numbers, the device
readings stay silent (no CUDA events on the CPU), and every reader is
silent on a program that records no spans."""

import functools

import pytest

from benchmark import registry, run
from benchmark.tests import _small

ROUNDS = ("rounds_cone_q8", "rounds_cone_q1")
EXTRACT = ("extract_textured",)
# metric: (kind, cells)
READERS = {
    "engine.k1_device_ms.round": ("device", ROUNDS),
    "engine.band_rows_ms.round": ("host", ROUNDS),
    "engine.band_unpack_ms.round": ("host", ROUNDS),
    "engine.band_fill.round": ("counter", ROUNDS),
    "optimizer.fetch_ms.round": ("host", ROUNDS),
    "optimizer.grid_ms.round": ("host", ROUNDS),
    "selection.select_ms.round": ("host", ROUNDS),
    "extract.upload_ms.batch": ("device", EXTRACT),
    "extract.flow_ms.batch": ("device", EXTRACT),
    "extract.nets_ms.batch": ("device", EXTRACT),
    "extract.host_wait_ms.batch": ("host", EXTRACT),
}


@functools.lru_cache(maxsize=None)
def traced(cell: str) -> dict:
    return _small.execute(cell, trace=True)


@pytest.mark.parametrize("name", list(READERS))
def test_a_span_reader_on_the_cpu_cells(name, monkeypatch):
    kind, cells = READERS[name]
    spec = registry.load_spec()
    assert registry.metric_entry(spec, name)["workloads"] == list(cells)
    for cell in cells:
        r = traced(cell)
        assert r["correct"], r["checks"]
        if kind == "device":
            assert name not in r["metrics"], cell
        else:
            assert r["metrics"][name]["value"] >= 0, cell
    if kind == "host":
        assert traced(cells[0])["metrics"][name]["value"] > 0
    if name == "engine.band_fill.round":
        assert 0 < traced(ROUNDS[0])["metrics"][name]["value"] <= 100
    # a program without the recorder (the parent of the spans): silent, no error
    import videoquery_torch.core.profiling as profiling

    monkeypatch.delattr(profiling, "trace_record")
    reader = registry.load_metric(name)
    work = {"poll_groups": 3, "batches": 2}
    assert reader.read(run.Run(None, work, {}, {})) is None
