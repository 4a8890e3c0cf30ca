"""The readings that a cell's limits are set from: the program's and the
control's.

    python3 -m benchmark.control --workload <cell> --seeds <n> ... \\
        [--control_seeds <n> ...] [--seconds 3]

For each seed, in one process: the cell's set-up and a short window at the
cell's own load, then the numbers its check compares (the program's
readings). For each control seed, the same numbers for the control: the
plain reference put in the program's place, computed in the precision
below the one the configuration states (``fp8``: per-tensor scaled
float8 e4m3 for the configurations' bf16 index and networks), and judged
by the same comparison with the float32/float64 reference. One JSON line a
seed on standard output. The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from benchmark import registry, run as bench_run

FP8_MAX = 448.0


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 under one scale for the tensor (its largest
    magnitude at e4m3's largest value), back in x's dtype, or float32 for a
    bf16 x."""
    out_dtype = torch.float32 if x.dtype == torch.bfloat16 else x.dtype
    xf = x.float()
    amax = xf.abs().amax().clamp(min=1e-30)
    scale = FP8_MAX / amax
    return ((xf * scale).to(torch.float8_e4m3fn).float() / scale).to(out_dtype)


def control_readings(loop_name: str, cell, limits: dict) -> dict:
    """The control's numbers under the cell's check."""
    if loop_name == "rounds":
        from benchmark.loops import rounds

        r = {"score_gap": 0.0, "fit_loss_gap": 0.0, "band_faults": 0, "selection_faults": 0}
        for g in sorted(cell.kept):
            grp = cell.pool[g]
            out = rounds.control_output(cell.world, cell.config, cell.hp, grp, fp8)
            got = rounds.judge_group(cell.world, cell.config, cell.hp, grp, out,
                                     limits["score_gap"])
            for k, v in got.items():
                r[k] = max(r[k], v) if k.endswith("gap") else r[k] + v
        return r
    if loop_name == "query":
        from benchmark.loops import query

        r = {"value_gap": 0.0, "rank_faults": 0}
        for i in sorted(cell.kept):
            vals, ids = query.control_output(cell, i, fp8)
            got = query.judge_batch(cell, i, vals, ids, limits["value_gap"])
            r["value_gap"] = max(r["value_gap"], got["value_gap"])
            r["rank_faults"] += got["rank_faults"]
        return r
    if loop_name == "extract":
        from benchmark.loops import extract

        r = {"rgb_rel_err": 0.0, "flow_rel_err": 0.0}
        for i in sorted(cell.kept):
            want = extract.reference_signatures(cell, i)
            got = extract.reference_signatures(cell, i, cast=fp8, gray_operands=fp8)
            for key in ("rgb", "flow"):
                err = float((got[key] - want[key]).abs().mean() / want[key].abs().mean())
                r[key + "_rel_err"] = max(r[key + "_rel_err"], err)
        return r
    raise ValueError(f"no control for the loop {loop_name!r}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control_seeds", type=int, nargs="*", default=[])
    p.add_argument("--seconds", type=float, default=3.0)
    args = p.parse_args(argv)
    bench_run.set_caches()
    if not torch.cuda.is_available():
        print("[control] needs a CUDA device", file=sys.stderr)
        return 2
    from benchmark.trace import Stages

    spec = registry.load_spec()
    entry = registry.find_cell(spec, args.workload)
    config = registry.load_config(spec, entry["config"])
    traffic = registry.load_traffic(entry["traffic"])
    loop = registry.load_loop(traffic)
    device = torch.device("cuda:0")
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = loop.Cell(config, traffic, seed, device, Stages(False))
        cell.warm()
        cell.run(args.seconds)
        torch.cuda.synchronize(device)
        cell.release()
        line = {"seed": seed, "program": {k: v["value"] for k, v in
                                          cell.check(traffic["limits"]).items()}}
        if seed in args.control_seeds:
            line["control"] = control_readings(traffic["loop"], cell, traffic["limits"])
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
