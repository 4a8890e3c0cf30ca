"""A cell, a configuration, a traffic mix and a per-layer metric are added
as new files and BENCHMARK.json entries, with no edit to a file that is
already there."""

import json
import os
import shutil

from benchmark import registry
from benchmark.tests import _small


def test_new_files_are_found_by_name(tmp_path):
    root = tmp_path / "checkout"
    bench = root / "benchmark"
    shutil.copytree(registry.BENCH_DIR, bench,
                    ignore=shutil.ignore_patterns(".cache", "__pycache__"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), root / "BENCHMARK.json")
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    before[root / "BENCHMARK.json"] = (root / "BENCHMARK.json").read_bytes()

    # a configuration, a traffic mix and a metric: new files only
    config = json.loads((bench / "configs" / "corpus_1m_tsn_bf16.json").read_text())
    config["name"] = "corpus_2m_tsn_bf16"
    (bench / "configs" / "corpus_2m_tsn_bf16.json").write_text(json.dumps(config))
    mix = json.loads((bench / "traffic" / "rounds_cone_q8.json").read_text())
    mix["queries_per_group"] = 2
    (bench / "traffic" / "rounds_cone_q2.json").write_text(json.dumps(mix))
    (bench / "metrics" / "rounds_seen.round.py").write_text(
        "def read(run):\n    return float(run.work['poll_groups'])\n")

    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": "corpus_2m_tsn_bf16", "source": "https://example.org/x",
                            "file": "benchmark/configs/corpus_2m_tsn_bf16.json",
                            "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "rounds_cone_q2", "config": "corpus_2m_tsn_bf16",
                              "traffic": "rounds_cone_q2", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "round_ms_p95":
            m["workloads"].append("rounds_cone_q2")
    spec["per_layer"].append({"name": "rounds_seen.round", "unit": "1", "better": "higher",
                              "source": "program_counter", "layer": "selection",
                              "moves": "round_ms_p95", "workloads": ["rounds_cone_q2"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))

    r = _small.execute("rounds_cone_q2", root=str(root), bench_dir=str(bench))
    assert r["correct"] and r["attempted"] % 2 == 0
    assert set(r["metrics"]) == {"round_ms_p95", "setup_s"}
    r = _small.execute("rounds_cone_q2", trace=True, root=str(root), bench_dir=str(bench))
    assert r["metrics"]["rounds_seen.round"]["value"] > 0

    edited = [str(p) for p, data in before.items()
              if p.name != "BENCHMARK.json" and p.read_bytes() != data]
    assert edited == []
