"""No run loads JAX or the JAX package, and the reference imports nothing
of the program."""

import ast
import os
import subprocess
import sys

from benchmark import registry, run

REF_DIR = os.path.join(registry.BENCH_DIR, "reference")


def test_forbidden_names_are_whole_top_level_names():
    assert run.forbidden_modules(["videoquery_torch", "videoquery_torch.search",
                                  "jaxtyping", "numpy"]) == []
    assert run.forbidden_modules(["videoquery.search", "jax", "jaxlib.xla", "flax",
                                  "torch"]) == ["flax", "jax", "jaxlib", "videoquery"]


def test_a_run_loads_no_jax():
    code = ("import sys, json; from benchmark.tests import _small; from benchmark import run; "
            "r = _small.execute('rounds_cone_q8'); "
            "print(json.dumps([r['correct'], run.forbidden_modules()]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, check=True,
                         capture_output=True, text=True, timeout=600,
                         env=dict(os.environ, PYTHONPATH=registry.ROOT))
    assert out.stdout.strip().splitlines()[-1] == "[true, []]"


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def test_reference_imports_nothing_of_the_program():
    files = [os.path.join(d, f) for d, _s, fs in os.walk(REF_DIR) for f in fs
             if f.endswith(".py")]
    assert files
    for path in files:
        for name in _imports(path):
            top = name.split(".")[0]
            assert top not in ("videoquery_torch", "videoquery", "jax", "jaxlib"), (path, name)
    code = ("import sys; import benchmark.reference.corpus, benchmark.reference.optimizer, "
            "benchmark.reference.selection, benchmark.reference.bninception, "
            "benchmark.reference.tvl1.pairs; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'videoquery_torch', 'videoquery', 'jax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=registry.ROOT, check=True,
                         capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, PYTHONPATH=registry.ROOT))
    assert out.stdout.strip() == "[]"


def test_without_a_card_the_command_prints_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "query_b16",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=registry.ROOT, capture_output=True, text=True, timeout=120,
                         env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
    assert out.returncode != 0 and out.stdout == ""
