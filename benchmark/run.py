"""Run one cell of the benchmark once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout, on a machine with the cell's NVIDIA GPUs: it
builds the program's kernels into fixed directories under
``benchmark/.cache/`` (only a checkout's first run compiles), makes the
cell's inputs and weights on the card from the seed, warms up the cell's
own shapes (all of that is ``setup_s``), runs the traffic's closed loop for
``--seconds`` seconds, frees the program's state, checks the outputs of the
window against the plain reference, and prints one JSON line last on
standard output::

    {"correct", "attempted", "failed", "metrics", "device", ["breakdown"], "checks"}

``metrics`` holds the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics, read from a ``torch.profiler`` trace of the window (at
most the traffic's ``trace_seconds``); ``checks`` holds each number
compared with its limit, and the same lines end standard error. Without a
CUDA device, with fewer than the cell's GPUs, or with ``jax``, ``jaxlib``,
``flax`` or the JAX package ``videoquery`` loaded once the window has
closed, it exits non-zero and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from benchmark import registry  # noqa: E402

CACHE = os.path.join(registry.BENCH_DIR, ".cache")
FORBIDDEN = ("jax", "jaxlib", "flax", "videoquery")


def set_caches(environ=os.environ, cache: str = CACHE) -> None:
    """Every build and kernel cache of the program at a fixed path inside
    the checkout."""
    environ["VIDEOQUERY_TORCH_BUILD_DIR"] = os.path.join(cache, "kernels")
    environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_extensions")
    environ["CUDA_CACHE_PATH"] = os.path.join(cache, "nv")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is, whole, one of FORBIDDEN."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def power_limit_w() -> float | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits", "-i", "0"],
                             capture_output=True, text=True, timeout=30, check=True)
        return float(out.stdout.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


class Run:
    """What a per-layer metric's ``read(run)`` is given."""

    def __init__(self, summary, work: dict, config: dict, traffic: dict):
        self.trace = summary
        self.work = work
        self.config = config
        self.traffic = traffic


def execute(cell_name: str, seed: int, seconds: float, trace: bool, device,
            root: str = registry.ROOT, t_start: float = T_START,
            config_override: dict | None = None, traffic_override: dict | None = None,
            bench_dir: str = registry.BENCH_DIR) -> dict:
    """One run of a cell on ``device``: the result line's fields. The CPU
    tests pass a CPU device and small overrides; the command line allows
    only a CUDA device."""
    import torch

    from benchmark.trace import Stages, traced_window

    spec = registry.load_spec(root)
    cell_entry = registry.find_cell(spec, cell_name)
    config = registry.load_config(spec, cell_entry["config"], root)
    traffic = registry.load_traffic(cell_entry["traffic"], bench_dir)
    config.update(config_override or {})
    traffic.update(traffic_override or {})
    loop = registry.load_loop(traffic)
    device = torch.device(device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    cell = loop.Cell(config, traffic, seed, device, Stages(trace, sync))
    cell.warm()
    sync()
    setup_s = time.perf_counter() - t_start
    summary = None
    if trace:
        with traced_window(device) as holder:
            cell.run(min(seconds, traffic["trace_seconds"]))
        summary = holder.summary
    else:
        cell.run(seconds)
        sync()
    memory_peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    metrics = {}
    names = registry.metric_names(spec, cell_entry, trace)
    if trace:
        run = Run(summary, cell.work(), config, traffic)
        for name in names:
            value = registry.load_metric(name, bench_dir).read(run)
            if value is not None:
                metrics[name] = value
    else:
        e2e = cell.end_to_end()
        e2e["setup_s"] = setup_s
        metrics = {n: e2e[n] for n in names if n in e2e}
    cell.release()
    checks = cell.check(traffic["limits"])
    correct = all(c["value"] <= c["limit"] for c in checks.values())
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda"
                   else "cpu",
                   "count": cell_entry["chips"], "memory_peak_bytes": int(memory_peak)}
    if trace:
        device_info["busy_s"] = summary.busy_s
        device_info["window_s"] = summary.window_s
    result = {"correct": bool(correct), "attempted": int(cell.attempted),
              "failed": int(cell.failed),
              "metrics": {n: {"value": float(v),
                              "unit": registry.metric_entry(spec, n)["unit"]}
                          for n, v in metrics.items()},
              "device": device_info}
    if trace:
        result["breakdown"] = summary.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    set_caches()
    args = parse_args(argv)
    import torch

    spec = registry.load_spec()
    chips = registry.find_cell(spec, args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"[benchmark] {args.workload} needs {chips} CUDA device(s); found {n}",
              file=sys.stderr)
        return 2
    kernels = os.environ["VIDEOQUERY_TORCH_BUILD_DIR"]
    if not (os.path.isdir(kernels) and os.listdir(kernels)):
        print(f"[benchmark] the first run in this checkout: set-up builds the kernels "
              f"into {kernels}", file=sys.stderr)
    result = execute(args.workload, args.seed, args.seconds, bool(args.trace), "cuda:0")
    found = forbidden_modules()
    if found:
        print(f"[benchmark] the run loaded {found}: the port must not import JAX "
              "or the JAX package", file=sys.stderr)
        return 3
    result["device"]["power_limit_w"] = power_limit_w()
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
