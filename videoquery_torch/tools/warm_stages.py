"""Where a warm-started flow batch's time goes, at production geometry.

Port of ``tools/warm_stages.py``. Times each piece of the warm-start flow
as its own call, at the shapes of an 8-clip batch (150 frames a clip, 125
pairs of the tick stacks, 128x128 flow grid, warm groups of 3: key pairs
solve the full pyramid, the others refine their key's flow):

  gathers     the i0/i1 takes of key and warm pairs and the output scatter
  cam_est     estimate_camera on the key pairs (cross-correlation, LK on K3)
  cam_apply   apply_camera on the warm pairs (roll + K3)
  warm_solve  one K2 call: 1 warp x warm_iters at d=8 on the warm pairs
  key_solve   the full warped pyramid on the key pairs (K3 and K2, d=8)
  full        _pair_flow_uv, warm g3 with the key's camera (cam=key)
  cold        _pair_flow_uv without the warm plan

then "accounted" (key_solve + cam_apply + warm_solve + gathers) against
full. Times from ``flow_bench.timeit`` (CUDA events on the card).

    python -m videoquery_torch.tools.warm_stages [--batch 8] [--reps 10]
    python -m videoquery_torch.tools.warm_stages --device cpu --batch 1 --frames 20 \\
        --hw 32 32 --ticks 3
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from videoquery_torch.tools.flow_bench import full_f32, timeit


def make_gray(batch: int, frames: int, h: int, w: int, device, seed: int = 0):
    """f32 [batch, frames, h, w] in [0, 1]: box-smoothed noise."""
    rng = np.random.default_rng(seed)
    base = rng.random((batch, frames + 1, h, w), np.float32)
    for ax in (2, 3):
        base = (np.roll(base, 1, ax) + base + np.roll(base, -1, ax)) / 3.0
    return torch.from_numpy(np.ascontiguousarray(base[:, :frames])).to(device)


def warm_plan(frames: int, ticks: int, depth: int, group: int, device):
    """(pair_idx, (key_pos, warm_pos, warm_src)) of a clip, on the device."""
    from videoquery_torch.pipeline.sampling import flow_pair_plan, flow_warm_plan

    pair_idx, _ = flow_pair_plan(frames, ticks, depth)

    def dev(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device)

    return dev(pair_idx), tuple(dev(a) for a in flow_warm_plan(pair_idx, group))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--frames", type=int, default=150)
    ap.add_argument("--hw", type=int, nargs=2, default=[128, 128], help="the flow grid")
    ap.add_argument("--ticks", type=int, default=25)
    ap.add_argument("--warm_group", type=int, default=3)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default cuda, or VIDEOQUERY_DEVICE)")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Time every row, print them and "accounted vs full"; return the rows
    and, under "outputs", the full row's (u, v)."""
    with full_f32():
        return _run(parse_args(argv))


def _run(args) -> dict:
    from videoquery_torch.core.device import resolve_device
    from videoquery_torch.kernels.tvl1_flow import (apply_camera, estimate_camera,
                                                    tvl1_warped_flow)
    from videoquery_torch.kernels.tvl1_level import tvl1_level
    from videoquery_torch.pipeline.extract import (PRODUCTION_TVL1, _pair_flow_uv,
                                                   warm_tvl1_params)

    device = resolve_device(args.device)
    b, (fh, fw), p, reps = args.batch, args.hw, PRODUCTION_TVL1, args.reps
    gray = make_gray(b, args.frames, fh, fw, device)
    pidx, warm = warm_plan(args.frames, args.ticks, 5, args.warm_group, device)
    kp, wp, ws = warm
    n_pairs, k, m = pidx.shape[0], kp.shape[0], wp.shape[0]
    print(f"batch {b}: {n_pairs} pairs a clip, {b * n_pairs} in all ({b * k} key + "
          f"{b * m} warm) at {fh}x{fw}, on {device}")

    t_full, full = timeit(_pair_flow_uv, gray, pidx, True, p, warm, "key", reps=reps)
    t_cold, _ = timeit(_pair_flow_uv, gray, pidx, True, p, None, reps=reps)

    i0k = gray[:, pidx][:, kp].reshape(b * k, fh, fw)
    i1k = gray[:, pidx + 1][:, kp].reshape(b * k, fh, fw)
    i1w = gray[:, pidx + 1][:, wp].reshape(b * m, fh, fw)
    i0w = gray[:, pidx][:, wp].reshape(b * m, fh, fw)

    def gathers(g):
        i0, i1 = g[:, pidx], g[:, pidx + 1]
        i0k_ = i0[:, kp].reshape(b * k, fh, fw)
        i1k_ = i1[:, kp].reshape(b * k, fh, fw)
        uk = i0k_ * 0.1                      # a stand-in for the key flow
        u0 = uk.reshape(b, k, fh, fw)[:, ws]
        i0w_ = i0[:, wp].reshape(b * m, fh, fw)
        i1w_ = i1[:, wp].reshape(b * m, fh, fw)
        u = torch.zeros((b, n_pairs, fh, fw), dtype=torch.float32, device=g.device)
        u[:, kp] = uk.reshape(b, k, fh, fw)
        u[:, wp] = u0
        return u.sum() + i0w_.sum() + i1w_.sum() + i0k_.sum() + i1k_.sum()

    t_gather, _ = timeit(gathers, gray, reps=reps)
    t_camest, cam = timeit(estimate_camera, i0k, i1k, p, reps=reps)
    cam_w = cam.reshape((b, k) + tuple(cam.shape[1:]))[:, ws].reshape(
        (b * m,) + tuple(cam.shape[1:]))
    t_camapply, i1wc = timeit(apply_camera, i1w, cam_w, reps=reps)
    u0 = torch.zeros((b * m, fh, fw), dtype=torch.float32, device=device)
    wtv = warm_tvl1_params(p)
    t_warmsolve, _ = timeit(tvl1_level, i0w, i1wc.contiguous(), u0, u0, wtv.at_level(0), 8,
                            reps=reps)
    t_keysolve, _ = timeit(tvl1_warped_flow, i0k, i1k, p, 8, reps=reps)

    rows = [
        ("full", f"FULL warm g{args.warm_group} cam=key", t_full),
        ("cold", "cold (no warm plan)", t_cold),
        ("key_solve", f"key solve (cam est + apply + pyramid), {b * k} pairs", t_keysolve),
        ("cam_est", "  cam_est alone (keys)", t_camest),
        ("cam_apply", f"warm cam_apply (roll + K3), {b * m} pairs", t_camapply),
        ("warm_solve", f"warm level solve (1 warp x {wtv.n_iters} iters, d=8)", t_warmsolve),
        ("gathers", "gathers + scatter (all pairs)", t_gather),
    ]
    for _key, name, sec in rows:
        print(f"  {name:55s} {sec * 1e3:9.3f} ms", flush=True)
    acct = t_keysolve + t_camapply + t_warmsolve + t_gather
    print(f"  => accounted {acct * 1e3:.3f} ms vs full {t_full * 1e3:.3f} ms; warm-side "
          f"plumbing (cam_apply + gathers) {(t_camapply + t_gather) * 1e3:.3f} ms", flush=True)
    return {"device": str(device), "pairs": b * n_pairs, "key_pairs": b * k,
            "warm_pairs": b * m,
            "rows": [{"row": key, "label": name, "ms": sec * 1e3} for key, name, sec in rows],
            "accounted_ms": acct * 1e3, "full_ms": t_full * 1e3,
            "outputs": {"full": full}}


def main(argv=None) -> None:
    out = run(argv)
    out.pop("outputs")
    print(json.dumps({"warm_stages": out}), flush=True)


if __name__ == "__main__":
    main()
