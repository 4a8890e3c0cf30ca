"""Does overlapping one batch's flow with the previous batch's CNN pay?

Port of ``tools/pipeline_overlap.py``. The extraction step is prep (gray,
the flow on K3 and K2, the gathers and the preprocess: ``prepare_step``)
then the CNN (both streams' ensembles: ``embed_step``). If the card ran
batch i + 1's prep while it runs batch i's CNN, a batch would cost
max(prep, CNN) instead of their sum. Three timing models at production
geometry (the ``extract_stages`` flags), steady-state ms a batch:

  A  extract_step as it ships, one call a batch;
  B  prep and CNN as two calls, prep[i + 1] issued before cnn[i], on one
     stream (any gain: the host's issue of the two overlapping the card);
  C  prep[i + 1] on a side stream while cnn[i] runs on the main one (the
     CUDA counterpart of the JAX tool's one program of two independent
     subgraphs): the main stream waits for the side stream's prep before
     it consumes it, and prep's outputs, allocated on the side stream, are
     recorded on the main one so the caching allocator does not hand
     their memory out while the CNN still reads it. On the CPU there are
     no streams and C issues in B's order.

Every loop alternates two batches of distinct seeded frames, and each
batch's signatures in B and C must equal A's for that batch bit for bit
(the same kernels on the same inputs); the tool raises otherwise. A buffer
handed out while the CNN still read it would hold the other batch's values
and show as a mismatch. It prints prep alone, the CNN alone and the
overlap ideal max(prep, CNN). Each loop runs max(2, --reps) batches.

    python -m videoquery_torch.tools.pipeline_overlap [--batch 8] [--reps 8]
    python -m videoquery_torch.tools.pipeline_overlap --device cpu --batch 1 --frames 20 \\
        --hw 64 96 --ticks 3 --splits 1 --resize 96 64 --crop 64 --reps 2
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time

import torch

from videoquery_torch.tools.extract_stages import add_geometry_args, build_from_args
from videoquery_torch.tools.flow_bench import full_f32, timeit


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    add_geometry_args(ap)
    return ap.parse_args(argv)


def _wall(fn, device) -> float:
    """Seconds of fn() on the host clock, the device synchronised on both
    sides."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    fn()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    return time.perf_counter() - t0


def run(argv=None) -> dict:
    """Time A, prep, CNN, B and C; check B's and C's signatures against
    A's; print the rows; return them."""
    with full_f32():
        return _run(parse_args(argv))


def _run(args) -> dict:
    import numpy as np

    from videoquery_torch.core.device import resolve_device
    from videoquery_torch.pipeline.extract import (PRODUCTION_TVL1,
                                                   embed_step, extract_step, prepare_step)

    device = resolve_device(args.device)
    bt = build_from_args(args, device)
    reps, b = max(2, args.reps), args.batch
    # two batches of distinct frames, taken in turn: batch i is batches[i % 2]
    batches = (bt.frames, torch.from_numpy(np.random.default_rng(1).integers(
        0, 255, tuple(bt.frames.shape), np.uint8)).to(device))

    def fused(i):
        return extract_step(bt.tsn, batches[i % 2], bt.plan, bt.cfg, True, PRODUCTION_TVL1,
                            bt.dtype)

    def prep(i):
        return prepare_step(batches[i % 2], bt.plan, bt.cfg, True, PRODUCTION_TVL1,
                            bt.dtype)

    def cnn(inputs):
        return embed_step(bt.tsn, *inputs)

    rows = {}
    want = [fused(0), fused(1)]
    outs = {"A": [], "B": [], "C": []}

    def loop_a():
        for i in range(reps):
            outs["A"].append(fused(i))

    rows["A"] = _wall(loop_a, device) / reps
    print(f"A extract_step as it ships  : {rows['A'] * 1e3:9.3f} ms a batch "
          f"({b / rows['A']:.2f} clips/s)", flush=True)
    rows["prep"], inputs = timeit(prep, 0, reps=reps)
    rows["cnn"], _ = timeit(cnn, inputs, reps=reps)
    ideal = max(rows["prep"], rows["cnn"])
    print(f"  prep alone {rows['prep'] * 1e3:9.3f} ms, cnn alone {rows['cnn'] * 1e3:9.3f} ms "
          f"(sum {(rows['prep'] + rows['cnn']) * 1e3:.3f}, max {ideal * 1e3:.3f} = "
          f"{b / ideal:.2f} clips/s if overlapped)", flush=True)

    # B and C start from batch 0's primed carry, so each timed rep is one
    # prep and one cnn, A's work
    def loop_b(carry):
        for i in range(reps):
            nxt = prep(i + 1)          # issued ahead of the cnn below
            outs["B"].append(cnn(carry))
            carry = nxt

    carry = prep(0)
    rows["B"] = _wall(lambda: loop_b(carry), device) / reps
    print(f"B prep[i+1] before cnn[i]   : {rows['B'] * 1e3:9.3f} ms a batch "
          f"({b / rows['B']:.2f} clips/s)", flush=True)

    if device.type == "cuda":
        main_stream = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
    else:
        main_stream = side = None

    def on_side():
        return torch.cuda.stream(side) if side is not None else contextlib.nullcontext()

    def loop_c(carry, sink):
        if side is not None:
            side.wait_stream(main_stream)      # the frames and the carry
        for i in range(reps):
            if side is not None:
                # cnn[i] reads what the side stream's prep wrote
                main_stream.wait_stream(side)
            sink.append(cnn(carry))
            with on_side():
                nxt = prep(i + 1)      # runs beside cnn[i]
            if side is not None:
                for t in nxt:
                    t.record_stream(main_stream)
            carry = nxt
        if side is not None:
            main_stream.wait_stream(side)

    loop_c(prep(0), [])                # warm the side stream's allocations
    carry = prep(0)
    rows["C"] = _wall(lambda: loop_c(carry, outs["C"]), device) / reps
    print(f"C prep[i+1] on a side stream: {rows['C'] * 1e3:9.3f} ms a batch "
          f"({b / rows['C']:.2f} clips/s)", flush=True)

    equal = {}
    for key in ("A", "B", "C"):
        equal[key] = len(outs[key]) == reps and all(
            torch.equal(g, w) for i, out in enumerate(outs[key])
            for g, w in zip(out, want[i % 2]))
    # the check sees a mixed-up batch only if the two batches' signatures differ
    equal["batches_differ"] = not any(torch.equal(g, w) for g, w in zip(*want))
    print(f"  each of {reps} batches (2 frame sets in turn) equal to A's bit for bit: "
          f"B {equal['B']}, C {equal['C']} (A again {equal['A']})", flush=True)
    if not all(equal.values()):
        raise AssertionError(f"pipelined signatures differ from extract_step's: {equal}")
    best = min(rows["A"], rows["B"], rows["C"])
    verdict = ("overlap pays: adopt the best schedule" if best < 0.9 * rows["A"]
               else "no gain of 10% or more from overlap here")
    print(f"=> best {best * 1e3:.3f} ms vs the overlap ideal {ideal * 1e3:.3f} ms: {verdict}",
          flush=True)
    return {"device": str(device), "ms": {k: v * 1e3 for k, v in rows.items()},
            "ideal_ms": ideal * 1e3, "clips_per_s": {k: b / rows[k] for k in "ABC"},
            "bitwise_equal_to_a": equal, "verdict": verdict}


def main(argv=None) -> None:
    print(json.dumps({"pipeline_overlap": run(argv)}), flush=True)


if __name__ == "__main__":
    main()
