"""Every cell of BENCHMARK.json runs end to end on the CPU at a tiny size,
with the kernels' plain versions, and comes out correct."""

import json

import pytest

from benchmark import registry
from benchmark.tests import _small

CELLS = [c["name"] for c in registry.load_spec()["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_and_is_correct(cell):
    r = _small.execute(cell)
    assert r["correct"], r["checks"]
    assert r["attempted"] > 0 and r["failed"] == 0
    spec = registry.load_spec()
    want = set(registry.metric_names(spec, registry.find_cell(spec, cell), trace=False))
    assert set(r["metrics"]) == want and "setup_s" in want and len(want) >= 2
    assert all(v["value"] > 0 for v in r["metrics"].values())
    assert list(r)[-1] == "checks"
    json.dumps(r)


@pytest.mark.parametrize("cell", ["rounds_cone_q8", "query_b16"])
def test_traced_run_reads_the_per_layer_metrics(cell):
    r = _small.execute(cell, trace=True)
    assert r["correct"]
    spec = registry.load_spec()
    names = registry.metric_names(spec, registry.find_cell(spec, cell), trace=True)
    # the CPU trace has host spans and no device: the device shares stay silent
    host = [n for n in names if registry.metric_entry(spec, n)["unit"] == "ms"]
    assert set(host) <= set(r["metrics"])
    assert not any(n.startswith("k1_roofline") for n in r["metrics"])
    assert r["device"]["window_s"] > 0 and set(r["breakdown"]) == {"device_ops", "idle_gaps"}


def test_every_cell_reports_what_the_contract_asks():
    spec = registry.load_spec()
    for cell in spec["workloads"]:
        e2e = registry.metric_names(spec, cell, trace=False)
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        per_layer = registry.metric_names(spec, cell, trace=True)
        assert per_layer, cell["name"]
        for name in per_layer:
            assert registry.metric_entry(spec, name)["moves"] in e2e, (cell["name"], name)
