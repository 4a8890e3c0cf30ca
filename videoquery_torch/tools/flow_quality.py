"""Flow quality gate: does a flow configuration change retrieval?

Port of ``tools/flow_quality.py``. It generates a synthetic corpus of clips
with distinct motion signatures (object velocities, camera pans, zoom,
jitter, perspective; corpus v4 adds time-varying motion and content cuts),
made from known motion fields, and extracts two-stream embeddings under
each configuration of a table: the faithful baseline (the gather-warp
TV-L1 at full resolution, ``flow_impl="xla"``, ``kernels/tvl1.py``) and the
production flow on K2 and K3 (``"pallas"``: reduced grid, window warps,
the fine-warp schedule, warm starts, rescue). Each row prints its
retrieval (the share of clips whose nearest flow-embedding neighbour is
their motion partner) and its endpoint error against the known residual
(camera-compensated) flow: mean, p90, object box, background. The last
line is one JSON object with every row's numbers.

The networks are ``TwoStreamTSN.random(0, splits=(1,))`` in f32, so
retrieval compares rows of one run only; EPE depends on the flow alone.

    python -m videoquery_torch.tools.flow_quality                 # the card
    python -m videoquery_torch.tools.flow_quality --final --corpus 3 --scale 2 --seeds 0 1 2
    python -m videoquery_torch.tools.flow_quality --device cpu --frames 6 --size 48 64
                                                                  # a tiny corpus
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

MOTION_CLASSES = [  # (object velocity, camera pan) — strongly distinct
    ((4.0, 0.0), (0.0, 0.0)),    # fast right
    ((-4.0, 0.0), (0.0, 0.0)),   # fast left
    ((0.0, 3.0), (0.0, 0.0)),    # down
    ((0.0, -3.0), (0.0, 0.0)),   # up
    ((0.0, 0.0), (0.0, 0.0)),    # static
    ((2.5, 2.5), (1.5, 0.0)),    # diagonal + pan (tests compensation)
    ((12.0, 0.0), (0.0, 0.0)),   # very fast right: >10 px/frame foreground,
                                 # near the reference's ±20 px quantization
                                 # bound (build_wof_clips.py:70-73)
    ((-7.0, 5.0), (2.0, 0.0)),   # fast diagonal + pan. NOTE: the object
                                 # motion must be UNIQUE per class — with
                                 # accurate camera compensation the pan is
                                 # (correctly) erased, so a pan class whose
                                 # object motion matches another class's
                                 # direction collapses onto it and the
                                 # metric punishes good compensation
    ((3.0, -3.0), "zoom"),       # camera zoom-in + diagonal object: tests
                                 # the parametric (LK) compensation — the
                                 # TV-flow-affine-fit estimator left zooms
                                 # uncompensated
    ((-2.5, -2.5), "jitter"),    # handheld-style pan with per-frame random
                                 # jitter: camera motion is NOT smooth
                                 # between neighbor pairs, so any scheme
                                 # that reuses a neighbor's camera estimate
                                 # (warm-start shortcuts) is punished here
    ((5.0, 1.5), "perspx"),      # camera PERSPECTIVE change about the
                                 # vertical axis (dash-cam/drone motion):
                                 # inexpressible by the affine model —
                                 # gates TVL1Params.camera_model
    ((-1.5, -5.0), "perspy"),    # perspective about the horizontal axis
]
ZOOM_PER_FRAME = 0.004           # 0.4%/frame zoom-in
JITTER_PAN = (1.5, 0.0)          # mean pan of the jitter class
JITTER_STD = 1.25                # px/frame camera jitter (per axis)

# CORPUS v4 (round 5): time-varying object motion + mid-clip content
# change. The v3 classes all have CONSTANT per-clip motion, so any evenly
# spaced tick subset sees the same signal (the tick-budget curve was flat
# by construction) and a warm-started neighbor pair's flow is always a
# good initializer (warm staleness was never stressed). These classes make
# both axes measurable:
#   - accel:   velocity grows linearly 0 -> ~2x the fast classes
#   - reverse: direction flips at mid-clip (worst case for warm chains)
#   - burst:   motion confined to a ~20% window of the clip (tick budgets
#              under-sample the event; mean-pooled embeddings get a
#              high-variance estimate of the motion share)
#   - cut:     the scene content is REPLACED mid-clip (texture and object;
#              the cut pair has no correspondence, so warm starts across
#              it inject garbage and rescue sees a saturated residual)
# Spec: {"kind", ...} per-frame velocity program + pan ("cut" = static
# camera with the content switch).
V4_CLASSES = [
    ({"kind": "accel", "a": (0.30, 0.0)}, (0.0, 0.0)),
    ({"kind": "accel", "a": (0.0, -0.22)}, (0.0, 0.0)),
    ({"kind": "reverse", "v": (5.0, 0.0)}, (0.0, 0.0)),
    ({"kind": "reverse", "v": (0.0, 4.0)}, (1.5, 0.0)),
    ({"kind": "burst", "v": (8.0, 0.0), "t0": 0.35, "t1": 0.55}, (0.0, 0.0)),
    ({"kind": "burst", "v": (0.0, 8.0), "t0": 0.65, "t1": 0.85}, (0.0, 0.0)),
    ({"kind": "const", "v": (3.0, 1.0)}, "cut"),
    ({"kind": "const", "v": (-3.0, -1.0)}, "cut"),
]


def _v4_vels(spec, frames: int) -> "np.ndarray":
    """Per-pair object velocity program [frames, 2] (px/frame, pre-scale)."""
    t = np.arange(frames, dtype=np.float64)[:, None]
    kind = spec["kind"]
    if kind == "accel":
        return t * np.asarray(spec["a"])[None]
    if kind == "reverse":
        v = np.asarray(spec["v"], np.float64)
        return np.where(t < frames // 2, v[None], -v[None])
    if kind == "burst":
        v = np.asarray(spec["v"], np.float64)
        on = (t >= spec["t0"] * frames) & (t < spec["t1"] * frames)
        return np.where(on, v[None], 0.0)
    if kind == "const":
        return np.broadcast_to(np.asarray(spec["v"], np.float64),
                               (frames, 2)).copy()
    raise ValueError(kind)
PERSP_RATE = 0.008               # perspective accumulation per frame (the
                                 # h31/h32 term in normalized [-1,1] coords:
                                 # ~0.7 px/frame of camera motion at the
                                 # frame edge at w=176, quadratic profile)


def _persp_mats(pan: str, t: float, h: int, w: int) -> "np.ndarray":
    """Output-window px -> base px homography for the persp classes at
    frame t (base is the 2h x 2w texture; window starts centered)."""
    kx = PERSP_RATE if pan == "perspx" else 0.0
    ky = PERSP_RATE if pan == "perspy" else 0.0
    N = np.array([[2.0 / w, 0, -1], [0, 2.0 / h, -1], [0, 0, 1]])
    C = np.array([[1, 0, 0], [0, 1, 0], [kx * t, ky * t, 1.0]])
    T = np.array([[1, 0, w / 2.0], [0, 1, h / 2.0], [0, 0, 1]])
    return T @ np.linalg.inv(N) @ C @ N


def make_corpus(frames=30, h=128, w=176, seed=0, scale=1, with_truth=False,
                version=4):
    """Two clips per motion class (different textures/objects, same motion):
    the retrieval metric is whether each clip's nearest flow-neighbor is its
    motion partner. scale multiplies resolution, object size AND velocities
    (proportional motion at production-like frame sizes).

    version=4 (default) appends the time-varying V4_CLASSES (accelerating /
    reversing / burst motion, mid-clip content cuts) to the 12 constant-
    motion v3 classes; version=3 reproduces the round-4 corpus exactly
    (the v3 gate numbers in docs/TUNING.md stay comparable).

    with_truth=True additionally returns per-clip ground-truth metadata
    (object box track + camera model) — the scenes are generated from KNOWN
    motion fields, so endpoint error against them is free (VERDICT r2 #3)."""
    import cv2

    rng = np.random.default_rng(seed)
    h, w, osz = h * scale, w * scale, 28 * scale
    classes = list(MOTION_CLASSES)
    if version >= 4:
        classes += V4_CLASSES
    clips, labels, truths = [], [], []
    for ci, (obj_v, pan) in enumerate(classes):
        for rep in range(2):
            # CORPUS v3 (round 4): coherent multi-scale textures at full
            # contrast. The original corpus Gaussian-blurred iid noise
            # (std collapsed to ~5/255 at scale 2 — BELOW TV-L1's
            # soft-threshold floor lambda*theta=0.045) and pasted an
            # UNBLURRED-noise object (near-zero spatial correlation, so
            # its motion is barely matchable at any speed). Measured
            # consequence: the solver returned near-zero flow on the
            # scale-2 corpus — a pure 3 px roll of a corpus frame solved
            # to 0.46 px — so object EPE degenerated to the truth
            # magnitude for EVERY config ("pinned ~10.4" was corpus
            # texture, not the window clamp) and only background/relative
            # comparisons carried signal. v3 textures have ~8-16 px
            # features at real-video contrast, making absolute EPE
            # meaningful; all gates were re-run on v3 (docs/TUNING.md).
            def _texture(hh, ww, coarse=16, fine=4):
                layers = []
                for cell, wgt in ((coarse, 1.0), (fine, 0.5)):
                    n_ = rng.random((hh // cell + 2, ww // cell + 2, 3))
                    layers.append(wgt * cv2.resize(
                        n_, (ww, hh), interpolation=cv2.INTER_CUBIC))
                t = sum(layers)
                t -= t.min()
                return (t / max(t.max(), 1e-9) * 255).astype(np.uint8)

            base = _texture(h * 2, w * 2, coarse=16 * scale,
                            fine=4 * scale)
            obj = _texture(osz, osz, coarse=8 * scale, fine=3 * scale)
            obj_xy = np.array([w * 0.25, h * 0.25]) + rng.uniform(0, 15 * scale, 2)
            fr, track, origins = [], [], []
            jitter = (rng.normal(0, JITTER_STD * scale, (frames, 2))
                      if pan == "jitter" else None)
            persp_mats = []
            if isinstance(obj_v, dict):  # v4 time-varying program
                vels = _v4_vels(obj_v, frames)
                # cum[t] = position offset at frame t; disp t->t+1 = vels[t]
                cum = np.vstack([np.zeros((1, 2)),
                                 np.cumsum(vels, axis=0)])[:frames]
                peak = np.max(np.abs(vels), axis=0)
                peak_v = (float(peak[0]), float(peak[1]))
            else:
                vels, cum, peak_v = None, None, obj_v
            cut_t, base2, obj2 = None, None, None
            if pan == "cut":
                cut_t = frames // 2
                base2 = _texture(h * 2, w * 2, coarse=16 * scale,
                                 fine=4 * scale)
                obj2 = _texture(osz, osz, coarse=8 * scale, fine=3 * scale)
            for t in range(frames):
                if pan in ("perspx", "perspy"):
                    M = _persp_mats(pan, t, h, w)
                    persp_mats.append(M)
                    f = cv2.warpPerspective(
                        base, M.astype(np.float64), (w, h),
                        flags=cv2.INTER_LINEAR | cv2.WARP_INVERSE_MAP)
                    origins.append(None)
                elif pan == "zoom":
                    # camera zoom-in about the window center
                    s = 1.0 + ZOOM_PER_FRAME * t
                    ch, cw = int(round(h / s)), int(round(w / s))
                    y0 = (h * 2 - ch) // 2
                    x0 = (w * 2 - cw) // 2
                    f = cv2.resize(base[y0:y0 + ch, x0:x0 + cw], (w, h))
                    origins.append(None)
                elif pan == "cut":
                    # static camera; the whole scene content is replaced at
                    # mid-clip (base2/obj2) — the cut pair has no pixel
                    # correspondence
                    b = base if t < cut_t else base2
                    f = b[:h, :w].copy()
                    origins.append((0, 0))
                else:
                    px_, py_ = (JITTER_PAN if pan == "jitter" else pan)
                    ox = int(t * px_ * scale
                             + (jitter[t, 0] if jitter is not None else 0)) % w
                    oy = int(t * py_ * scale
                             + (jitter[t, 1] if jitter is not None else 0)) % h
                    f = base[oy:oy + h, ox:ox + w].copy()
                    origins.append((ox, oy))
                if cum is not None:  # v4 time-varying program
                    px = int(obj_xy[0] + cum[t, 0] * scale) % (w - osz)
                    py = int(obj_xy[1] + cum[t, 1] * scale) % (h - osz)
                else:
                    px = int(obj_xy[0] + t * obj_v[0] * scale) % (w - osz)
                    py = int(obj_xy[1] + t * obj_v[1] * scale) % (h - osz)
                cur_obj = (obj2 if (cut_t is not None and t >= cut_t
                                    and obj2 is not None) else obj)
                f[py:py + osz, px:px + osz] = cur_obj
                fr.append(f)
                track.append((px, py))
            clips.append(np.stack(fr))
            labels.append(ci)
            truths.append({"obj_v": peak_v, "pan": pan, "osz": osz,
                           "track": track, "origins": origins,
                           "scale": scale, "persp_mats": persp_mats,
                           "vels": vels, "cut_t": cut_t})
    clips = np.stack(clips)
    labels = np.asarray(labels)
    if with_truth:
        return clips, labels, truths
    return clips, labels  # [C, F, H, W, 3], [C]


def truth_residual_flow(meta, t, h, w):
    """Ground-truth CAMERA-COMPENSATED (residual) flow for pair t -> t+1,
    or None when the pair is untestable (object or pan modulo-wrap).

    Returns (field f32[h, w, 2], valid_mask bool[h, w]). Background residual
    is 0 by construction (ideal compensation erases the pan/zoom); the
    object box at frame t carries its true displacement minus the camera
    field there (what TV-L1 on the ideally-warped pair measures). The
    object's frame-t+1 footprint is masked out (occlusion/disocclusion has
    no single ground truth)."""
    (px0, py0), (px1, py1) = meta["track"][t], meta["track"][t + 1]
    osz = meta["osz"]
    scale = meta["scale"]
    obj_v, pan = meta["obj_v"], meta["pan"]
    vels = meta.get("vels")
    cut_t = meta.get("cut_t")
    if cut_t is not None and t + 1 == cut_t:
        return None  # the cut pair has no pixel correspondence
    if vels is not None:
        # v4 time-varying program: the pair's displacement is vels[t]
        # (+2.5: int-rounding of both endpoint positions)
        if (abs(px1 - px0) > abs(vels[t, 0]) * scale + 2.5
                or abs(py1 - py0) > abs(vels[t, 1]) * scale + 2.5):
            return None  # object modulo-wrap
    elif (abs(px1 - px0) > abs(obj_v[0]) * scale + 1.5
            or abs(py1 - py0) > abs(obj_v[1]) * scale + 1.5):
        return None  # object modulo-wrap
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    if pan in ("perspx", "perspy"):
        # content at output x in frame t sits at base point M_t x; in frame
        # t+1 it appears at M_{t+1}^-1 M_t x — the exact camera field
        M0, M1 = meta["persp_mats"][t], meta["persp_mats"][t + 1]
        P = np.linalg.inv(M1) @ M0
        denom = P[2, 0] * xs + P[2, 1] * ys + P[2, 2]
        cam_x = (P[0, 0] * xs + P[0, 1] * ys + P[0, 2]) / denom - xs
        cam_y = (P[1, 0] * xs + P[1, 1] * ys + P[1, 2]) / denom - ys
    elif pan == "zoom":
        s0 = 1.0 + ZOOM_PER_FRAME * t
        s1 = 1.0 + ZOOM_PER_FRAME * (t + 1)
        r = s1 / s0 - 1.0
        cam_x = (xs - (w - 1) / 2.0) * r
        cam_y = (ys - (h - 1) / 2.0) * r
    elif pan == "cut":
        cam_x = np.zeros((h, w), np.float32)  # static camera
        cam_y = np.zeros((h, w), np.float32)
    else:
        (ox0, oy0), (ox1, oy1) = meta["origins"][t], meta["origins"][t + 1]
        dox, doy = ox1 - ox0, oy1 - oy0
        if pan == "jitter":
            lim_x = (abs(JITTER_PAN[0]) + 5 * JITTER_STD) * scale + 1.5
            lim_y = (abs(JITTER_PAN[1]) + 5 * JITTER_STD) * scale + 1.5
        else:
            lim_x = abs(pan[0]) * scale + 1.5
            lim_y = abs(pan[1]) * scale + 1.5
        if abs(dox) > lim_x or abs(doy) > lim_y:
            return None  # pan wrapped
        cam_x = np.full((h, w), -float(dox), np.float32)
        cam_y = np.full((h, w), -float(doy), np.float32)
    field = np.zeros((h, w, 2), np.float32)
    in_box0 = np.zeros((h, w), bool)
    in_box0[py0:py0 + osz, px0:px0 + osz] = True
    field[..., 0] = np.where(in_box0, (px1 - px0) - cam_x, 0.0)
    field[..., 1] = np.where(in_box0, (py1 - py0) - cam_y, 0.0)
    valid = np.ones((h, w), bool)
    # frame-t+1 object footprint: disoccluded background, no ground truth
    valid[py1:py1 + osz, px1:px1 + osz] = False
    valid[py0:py0 + osz, px0:px0 + osz] = True  # box0 keeps its truth
    return field, valid



def _mean(x: torch.Tensor) -> float:
    """Mean of a 1-D tensor in float64; NaN when it is empty (nanmean of
    nothing but NaN)."""
    return float(x.double().mean()) if x.numel() else float("nan")


def _p90(x: torch.Tensor) -> float:
    """The 90th percentile of a 1-D tensor, numpy.nanpercentile's linear
    interpolation (torch.nanquantile refuses inputs over 2**24 values)."""
    n = x.numel()
    if not n:
        return float("nan")
    k = 0.9 * (n - 1)
    lo = int(np.floor(k))
    hi = min(lo + 1, n - 1)
    a, b = (float(s) for s in torch.sort(x).values[[lo, hi]])
    t = k - lo
    return a + (b - a) * t if t < 0.5 else b - (b - a) * (1 - t)


def epe_for_config(clips, truths, impl, tvl1, flow_res_div, margin=12,
                   warm_group=0, warm_camera="own", gray_matmul=False,
                   host_gray="", warm_advect=0, only_pans=None,
                   only_fast=0.0, device="cuda"):
    """Mean/percentile endpoint error of a flow config against the corpus's
    known residual-motion fields, in the production flow geometry (gray,
    lane-aligned reduced grid, value rescale: extract.extract_step), split
    into object box and background (the background isolates camera
    compensation). warm_group > 1 evaluates the warm-start path. The flow
    and the error stay on the device; four numbers come back."""
    from videoquery_torch.kernels.resize import resize2
    from videoquery_torch.kernels.tvl1 import tvl1_warped_flow
    from videoquery_torch.pipeline.extract import (_flow_gray_grid,
                                                   _pair_flow_uv)
    from videoquery_torch.pipeline.payload import flow_grid_shape
    from videoquery_torch.pipeline.sampling import flow_warm_plan

    c, f, h, w = clips.shape[:4]
    if host_gray:
        # the compact-upload gray source (ExtractionConfig.host_gray): cv2
        # uint8 gray + resize on the host
        from videoquery_torch.pipeline import decode

        fh, fw = flow_grid_shape(h, w, flow_res_div)
        gh = decode.gray_flow_grid(clips.reshape((c * f,) + clips.shape[2:]), fh, fw,
                                   interp=host_gray)
        g = torch.from_numpy(gh.reshape(c, f, fh, fw).astype(np.float32) / 255.0).to(device)
        vscale = (w / fw, h / fh)
    else:
        g, vscale = _flow_gray_grid(torch.from_numpy(clips).to(device), flow_res_div,
                                    matmul=gray_matmul)
        fh, fw = g.shape[2:4]
    if impl == "pallas":
        pair_idx = np.arange(f - 1)
        plan = None
        if warm_group > 1:
            kp, wp, ws = flow_warm_plan(pair_idx, warm_group)
            if wp.size:
                plan = tuple(torch.as_tensor(a.astype(np.int64), device=device)
                             for a in (kp, wp, ws))
        u, v = _pair_flow_uv(g, torch.as_tensor(pair_idx, device=device), True, tvl1,
                             plan, warm_camera=warm_camera, warm_advect=warm_advect)
        u = u.reshape(c * (f - 1), fh, fw)
        v = v.reshape(c * (f - 1), fh, fw)
    else:
        i0 = g[:, :-1].reshape(c * (f - 1), fh, fw)
        i1 = g[:, 1:].reshape(c * (f - 1), fh, fw)
        u, v = tvl1_warped_flow(i0, i1, tvl1)

    # ground truth and masks assembled on the host, the error reduced on
    # the device
    gts, valids, boxes, keep = [], [], [], []
    for ci in range(c):
        for t in range(f - 1):
            # only_pans / only_fast: restrict the error accounting to
            # specific camera classes (the camera-model gate) or to object
            # speeds above a px/frame bound (the rescue gate)
            include = ((only_pans is None or truths[ci]["pan"] in only_pans)
                       and np.hypot(*truths[ci]["obj_v"]) >= only_fast)
            gt = truth_residual_flow(truths[ci], t, h, w) if include else None
            if gt is None:
                gts.append(np.zeros((h, w, 2), np.float32))
                valids.append(np.zeros((h, w), bool))
                boxes.append(np.zeros((h, w), bool))
                keep.append(False)
                continue
            field, valid = gt
            m = valid.copy()
            m[:margin] = m[-margin:] = False
            m[:, :margin] = m[:, -margin:] = False
            gts.append(field)
            valids.append(m)
            boxes.append(np.abs(field).sum(-1) > 0)
            keep.append(m.any())
    gt = torch.from_numpy(np.stack(gts)).to(device)
    valid = torch.from_numpy(np.stack(valids) & np.asarray(keep)[:, None, None]).to(device)
    box = torch.from_numpy(np.stack(boxes)).to(device)
    uu = resize2(u * vscale[0], (h, w))
    vv = resize2(v * vscale[1], (h, w))
    err = torch.sqrt((uu - gt[..., 0]) ** 2 + (vv - gt[..., 1]) ** 2)
    masked = err[valid]
    return {"epe_mean": _mean(masked), "epe_p90": _p90(masked),
            "epe_obj": _mean(err[valid & box]), "epe_bg": _mean(err[valid & ~box])}


def extract(clips, flow_impl, tvl1, flow_res_div, tsn, warm_group=0,
            warm_camera="own", gray_matmul=False, host_gray="",
            warm_advect=0, device="cuda"):
    """(rgb, flow) embeddings f64 [K, C, 1024] of the corpus: 9 ticks a
    clip, stacks of depth 5, the extraction geometry (340, 256) cropped to
    224, f32 networks; the production step (extract.extract_step)."""
    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.pipeline.extract import extract_step, step_plan
    from videoquery_torch.pipeline.payload import flow_grid_shape
    from videoquery_torch.pipeline.sampling import frame_ticks

    c, f = clips.shape[:2]
    cfg = ExtractionConfig(num_ticks=9, flow_stack_depth=5, frame_resize=(340, 256),
                           crop_size=224, flow_bound=20.0, flow_res_div=flow_res_div,
                           flow_warm_group=warm_group, flow_warm_camera=warm_camera,
                           flow_gray_matmul=gray_matmul, host_gray=bool(host_gray))
    plan = step_plan(f, cfg, flow_impl, device)
    frames_in, gray_u8 = clips, None
    if host_gray:
        from videoquery_torch.pipeline import decode

        h, w = clips.shape[2:4]
        fh, fw = flow_grid_shape(h, w, flow_res_div)
        gh = decode.gray_flow_grid(clips.reshape((c * f,) + clips.shape[2:]), fh, fw,
                                   interp=host_gray)
        gray_u8 = torch.from_numpy(gh.reshape(c, f, fh, fw)).to(device)
        frames_in = np.ascontiguousarray(clips[:, frame_ticks(f, 9, 1) - 1])
    rgb, flow = extract_step(tsn, torch.from_numpy(frames_in).to(device), plan, cfg, True,
                             tvl1, "float32", gray_u8=gray_u8, flow_impl=flow_impl,
                             warm_advect=warm_advect)
    return rgb.double().cpu().numpy(), flow.double().cpu().numpy()


def cosine(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1) + 1e-12)


def ranking(emb):  # [K, C, D] -> per-clip neighbor order by mean-split cosine
    e = emb.mean(axis=0)
    sims = cosine(e[:, None], e[None, :])
    return np.argsort(-sims, axis=1)


def partner_accuracy(emb, labels):
    """Fraction of clips whose nearest flow-neighbor shares their motion
    class (each class has exactly one partner)."""
    e = emb.mean(axis=0)
    sims = cosine(e[:, None], e[None, :])
    np.fill_diagonal(sims, -np.inf)
    nn = sims.argmax(axis=1)
    return float((labels[nn] == labels).mean())




def k2_routes(fh: int, fw: int, tvl1, max_disp: int = 6) -> list[dict]:
    """K2's route (kernels/tvl1_level.level_plan) at each pyramid level of
    a flow grid, and at the rescue's doubled window where the config has
    one."""
    from videoquery_torch.kernels.tvl1 import _pyramid_shapes
    from videoquery_torch.kernels.tvl1_flow import _level_disp
    from videoquery_torch.kernels.tvl1_level import level_plan

    shapes = _pyramid_shapes(fh, fw, tvl1)
    windows = [max_disp] + ([2 * max_disp] if tvl1.rescue_frac > 0 else [])
    return [{"h": h, "w": w, "d": _level_disp(md, tvl1, i),
             "route": level_plan(1, h, w, _level_disp(md, tvl1, i)).route}
            for md in windows for i, (h, w) in enumerate(shapes)]


def config_table(args, TVL1Params, PRODUCTION_TVL1) -> dict:
    """The rows a run measures, as the flags pick them: name -> (impl, tvl1,
    flow_res_div[, warm_group, warm_camera, gray_matmul, host_gray,
    warm_advect])."""
    configs = {
        "baseline (xla full-res s5w5i30)": ("xla", TVL1Params(), 1),
        "pallas full-res": ("pallas", TVL1Params(fine_warps=2), 1),
        # the Extractor's own schedule, so this headline row always
        # measures what ships
        "pallas half-res (production)": ("pallas", PRODUCTION_TVL1, 2),
        "pallas quarter-res": ("pallas", TVL1Params(fine_warps=2), 4),
    }
    if args.scale >= 2:
        # the JAX package's full-res gather program faults the TPU worker on
        # 16x30 256x352 frames, so its table has no baseline here either
        configs.pop("baseline (xla full-res s5w5i30)", None)
    if args.res_sweep:
        gw = PRODUCTION_TVL1
        prod = dataclasses.replace(gw, grad_source="image")
        configs = {
            "prod sched div2": ("pallas", prod, 2),
            "prod div2 grad=warped": ("pallas", gw, 2),
            "prod gw coarse 48x64": (
                "pallas", dataclasses.replace(gw, coarse_hw=(48, 64)), 2),
            "prod gw coarse 32x48": (
                "pallas", dataclasses.replace(gw, coarse_hw=(32, 48)), 2),
            "prod sched div3": ("pallas", prod, 3),
            "prod sched div4": ("pallas", prod, 4),
        }
    if args.warm:
        # 4th field = warm_group, 5th = warm_camera, 8th = warm_advect
        # (window size; group//2 * 8 covers the advection displacement);
        # the gate is warm == cold on EPE (incl. the jitter class) +
        # retrieval
        configs = {
            "prod cold (reference)": ("pallas", PRODUCTION_TVL1, 2),
            "prod warm group5": ("pallas", PRODUCTION_TVL1, 2, 5),
            "prod warm group3": ("pallas", PRODUCTION_TVL1, 2, 3),
            "prod warm g3 cam=key": ("pallas", PRODUCTION_TVL1, 2, 3, "key"),
            "prod warm g5 cam=key": ("pallas", PRODUCTION_TVL1, 2, 5, "key"),
            "prod warm g5 key advect": (
                "pallas", PRODUCTION_TVL1, 2, 5, "key", False, "", 16),
            "prod warm g7 key advect": (
                "pallas", PRODUCTION_TVL1, 2, 7, "key", False, "", 24),
        }
    if args.gray:
        # 6th field = gray_matmul; gate is graymm == exact on EPE +
        # retrieval at the full production flow config (warm g3 cam=key)
        configs = {
            "prod exact gray (f32)": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", False),
            "prod graymm (bf16 matmul)": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True),
        }
    if args.warm_iters:
        configs = {
            "cold (reference)": ("pallas", PRODUCTION_TVL1, 2),
            "warm_iters=fine (10)": (
                "pallas", dataclasses.replace(PRODUCTION_TVL1, warm_iters=None),
                2, 3, "key", True),
            "prod warm_iters=6": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True),
            "warm_iters=16": (
                "pallas", dataclasses.replace(PRODUCTION_TVL1, warm_iters=16),
                2, 3, "key", True),
            "wi=16 cam=own": (
                "pallas", dataclasses.replace(PRODUCTION_TVL1, warm_iters=16),
                2, 3, "own", True),
            "wi=16 warps2 cam=own": (
                "pallas", dataclasses.replace(PRODUCTION_TVL1, warm_iters=16,
                                              warm_warps=2),
                2, 3, "own", True),
        }
    if args.final:
        # the production-candidate shootout: homography camera + rescue,
        # warm cam=own vs cam=key vs cold
        H = dataclasses.replace(PRODUCTION_TVL1, camera_model="homography")
        HR = dataclasses.replace(H, rescue_frac=0.125)
        configs = {
            "cold homog (quality ref)": ("pallas", H, 2, 0, "own", True),
            "warm g3 own homog+rescue": ("pallas", HR, 2, 3, "own", True),
            "warm g3 init homog+rescue": ("pallas", HR, 2, 3, "init", True),
            "warm g3 key homog+rescue": ("pallas", HR, 2, 3, "key", True),
            "warm g3 own affine+rescue": (
                "pallas", dataclasses.replace(PRODUCTION_TVL1, rescue_frac=0.125),
                2, 3, "own", True),
        }
    if args.rescue:
        configs = {
            "prod (no rescue)": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True),
            "rescue f=1/8": (
                "pallas", dataclasses.replace(PRODUCTION_TVL1, rescue_frac=0.125),
                2, 3, "key", True),
            "rescue f=1/4": (
                "pallas", dataclasses.replace(PRODUCTION_TVL1, rescue_frac=0.25),
                2, 3, "key", True),
        }
    if args.camera:
        configs = {
            "prod affine (ships)": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True),
            "prod homography": (
                "pallas",
                dataclasses.replace(PRODUCTION_TVL1, camera_model="homography"),
                2, 3, "key", True),
        }
    if args.host_gray:
        # 7th field = host_gray interp; gate is host gray == device gray on
        # EPE + retrieval at the full production flow config
        configs = {
            "prod device gray (bf16 matmul)": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True, ""),
            "host gray cv2 area": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True, "area"),
            "host gray cv2 area2 (box+area)": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True, "area2"),
            "host gray cv2 linear": (
                "pallas", PRODUCTION_TVL1, 2, 3, "key", True, "linear"),
        }
    if args.sweep:
        configs.update({
            "half-res s5w5i30 (conservative)": (
                "pallas", TVL1Params(fine_warps=2), 2),
            "half-res s4 i20 fi15": (
                "pallas", TVL1Params(n_scales=4, fine_warps=2, n_iters=20,
                                     fine_iters=15), 2),
            "half-res w3 i20 fi10": (
                "pallas", TVL1Params(n_warps=3, fine_warps=2, n_iters=20,
                                     fine_iters=10), 2),
            "half-res s4 w3 i20 fi10": (
                "pallas", TVL1Params(n_scales=4, n_warps=3, fine_warps=2,
                                     n_iters=20, fine_iters=10), 2),
            "half-res full-window (no separable)": (
                "pallas", TVL1Params(fine_warps=2, separable_warp=False), 2),
            # cheaper candidates for the corrected-lambda regime: the
            # stronger data term converges in fewer iterations
            "half-res s4 w2 i12 fi8": (
                "pallas", TVL1Params(n_scales=4, n_warps=2, fine_warps=2,
                                     n_iters=12, fine_iters=8), 2),
            "half-res s3 w2 i10 fi6": (
                "pallas", TVL1Params(n_scales=3, n_warps=2, fine_warps=2,
                                     n_iters=10, fine_iters=6), 2),
            "prod sched grad=image": (
                "pallas", dataclasses.replace(
                    PRODUCTION_TVL1, grad_source="image"), 2),
        })
    return configs


def parse_args(argv=None):
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sweep", action="store_true",
                    help="also sweep reduced-iteration candidate configs")
    ap.add_argument("--seeds", type=int, nargs="+", default=[0],
                    help="corpus seeds; accuracy averages across them")
    ap.add_argument("--corpus", type=int, default=4, choices=[3, 4],
                    help="corpus version: 4 (default) adds time-varying "
                         "motion + content cuts; 3 = the constant-motion "
                         "corpus (docs/TUNING.md's gate numbers)")
    ap.add_argument("--scale", type=int, default=1,
                    help="corpus resolution/motion multiplier (2 =~ the "
                         "production 256x340 decode geometry)")
    ap.add_argument("--res_sweep", action="store_true",
                    help="sweep flow_res_div at the production schedule "
                         "instead of the schedule sweep")
    ap.add_argument("--no_epe", action="store_true",
                    help="skip the ground-truth endpoint-error metric "
                         "(retrieval accuracy only)")
    ap.add_argument("--warm", action="store_true",
                    help="gate the temporal warm-start path vs cold at the "
                         "production schedule")
    ap.add_argument("--gray", action="store_true",
                    help="gate the bf16 matmul-folded gray+resize against "
                         "the exact f32 path at the production config")
    ap.add_argument("--warm_iters", action="store_true",
                    help="sweep the warm-pair refinement iteration count "
                         "(TVL1Params.warm_iters) at the production config")
    ap.add_argument("--final", action="store_true",
                    help="production-candidate shootout: homography "
                         "+ rescue, warm cam=own/init/key vs cold")
    ap.add_argument("--rescue", action="store_true",
                    help="gate the fast-motion escalation pass "
                         "(TVL1Params.rescue_frac): re-solve clamp-"
                         "saturated pairs at a doubled window; reports "
                         "overall + fast-class-only EPE")
    ap.add_argument("--camera", action="store_true",
                    help="gate TVL1Params.camera_model: homography (8-param "
                         "perspective, dense_flow's model class) vs the "
                         "6-param affine at the full production config; "
                         "reports overall + persp-class-only EPE")
    ap.add_argument("--host_gray", action="store_true",
                    help="gate the compact-upload host gray source "
                         "(cv2 uint8, ExtractionConfig.host_gray) against "
                         "the on-device gray at the production config")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the kernels' "
                         "plain versions)")
    ap.add_argument("--frames", type=int, default=30,
                    help="frames a clip (a smaller corpus for the CPU)")
    ap.add_argument("--size", type=int, nargs=2, default=[128, 176],
                    metavar=("H", "W"), help="frame size at scale 1 (a "
                    "smaller corpus for the CPU; the object is 28 px)")
    return ap.parse_args(argv)


def run(argv=None) -> dict:
    """Run the table the flags pick; print one line a row (and the seed
    means, and the rows' cosines against the baseline where it ran).
    Returns every row's numbers."""
    from videoquery_torch.core.device import resolve_device
    from videoquery_torch.kernels.tvl1 import TVL1Params
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.pipeline.extract import PRODUCTION_TVL1, disable_tf32
    from videoquery_torch.pipeline.payload import flow_grid_shape

    args = parse_args(argv)
    device = resolve_device(args.device)
    disable_tf32()
    tsn = TwoStreamTSN.random(0, splits=(1,), device=device)
    configs = config_table(args, TVL1Params, PRODUCTION_TVL1)
    h, w = (s * args.scale for s in args.size)
    rows = []
    accs = {name: [] for name in configs}
    epes = {name: [] for name in configs}
    results = {}
    for seed in args.seeds:
        clips, labels, truths = make_corpus(frames=args.frames, h=args.size[0],
                                            w=args.size[1], seed=seed, scale=args.scale,
                                            with_truth=True, version=args.corpus)
        for name, cfg in configs.items():
            impl, tvl1, div = cfg[:3]
            kw = dict(warm_group=cfg[3] if len(cfg) > 3 else 0,
                      warm_camera=cfg[4] if len(cfg) > 4 else "own",
                      gray_matmul=cfg[5] if len(cfg) > 5 else False,
                      host_gray=cfg[6] if len(cfg) > 6 else "",
                      warm_advect=cfg[7] if len(cfg) > 7 else 0, device=device)
            t0 = time.time()
            rgb, flow = extract(clips, impl, tvl1, div, tsn, **kw)
            seconds = time.time() - t0
            if seed == args.seeds[0]:
                results[name], labels0 = (rgb, flow), labels
            acc = partner_accuracy(flow, labels)
            accs[name].append(acc)
            row = {"seed": seed, "name": name, "impl": impl, "flow_res_div": div,
                   "camera": tvl1.camera_model, "seconds": seconds, "retrieval": acc}
            line = (f"[{seconds:6.1f}s] seed {seed} {name:36s} "
                    f"retrieval: {acc:.2f}")
            if not args.no_epe:
                t1 = time.time()
                e = epe_for_config(clips, truths, impl, tvl1, div, **kw)
                epes[name].append(e)
                row.update(e)
                line += (f"  EPE mean {e['epe_mean']:.3f} p90 "
                         f"{e['epe_p90']:.3f} obj {e['epe_obj']:.3f} "
                         f"bg {e['epe_bg']:.3f}")
                if args.camera:
                    ep = epe_for_config(clips, truths, impl, tvl1, div,
                                        only_pans=("perspx", "perspy"), **kw)
                    row["persp_only"] = ep
                    line += (f"  persp-only mean {ep['epe_mean']:.3f} "
                             f"bg {ep['epe_bg']:.3f}")
                if args.rescue:
                    ef = epe_for_config(clips, truths, impl, tvl1, div,
                                        only_fast=8.5, **kw)
                    row["fast_only"] = ef
                    line += (f"  fast-only obj {ef['epe_obj']:.3f} "
                             f"mean {ef['epe_mean']:.3f}")
                row["epe_seconds"] = time.time() - t1
            if impl == "pallas":
                row["k2_routes"] = k2_routes(*flow_grid_shape(h, w, div), tvl1)
            rows.append(row)
            print(line, flush=True)
    out = {"device": (torch.cuda.get_device_name(device) if device.type == "cuda"
                      else "cpu"),
           "args": vars(args), "rows": rows, "means": {}}
    if len(args.seeds) > 1:
        print("-- mean over seeds", args.seeds)
        for name, a in accs.items():
            line = f"{name:40s} acc {np.mean(a):.3f}  (per-seed {a})"
            out["means"][name] = {"retrieval": float(np.mean(a))}
            if epes[name]:
                m = {k: float(np.mean([e[k] for e in epes[name]]))
                     for k in ("epe_mean", "epe_obj", "epe_bg")}
                out["means"][name].update(m)
                line += "  EPE {:.3f} obj {:.3f} bg {:.3f}".format(
                    m["epe_mean"], m["epe_obj"], m["epe_bg"])
            print(line)

    if "baseline (xla full-res s5w5i30)" in results:
        base_rgb, base_flow = results.pop("baseline (xla full-res s5w5i30)")
        out["cosine_vs_baseline"] = {}
        for name, (rgb, flow) in results.items():
            cos = cosine(flow.reshape(-1, flow.shape[-1]),
                         base_flow.reshape(-1, base_flow.shape[-1]))
            # where the least cosine sits: split k, clip c of the first
            # seed's corpus, its class, and both embeddings' norms
            k, c = divmod(int(np.argmin(cos)), flow.shape[1])
            worst = {"split": k, "clip": c, "label": int(labels0[c]),
                     "norm": float(np.linalg.norm(flow[k, c])),
                     "baseline_norm": float(np.linalg.norm(base_flow[k, c]))}
            out["cosine_vs_baseline"][name] = {"median": float(np.median(cos)),
                                               "min": float(cos.min()), "min_at": worst}
            print(f"{name:40s} flow-emb cosine vs baseline: "
                  f"median {np.median(cos):.4f} min {cos.min():.4f} (clip {c}, class "
                  f"{worst['label']}: norms {worst['norm']:.3g} and "
                  f"{worst['baseline_norm']:.3g})")
        rgb0 = next(iter(results.values()))[0]
        out["rgb_max_diff"] = float(np.abs(rgb0 - base_rgb).max())
        print("rgb stream max |diff| across configs:", out["rgb_max_diff"])
    return out


def main(argv=None) -> None:
    print(json.dumps({"flow_quality": run(argv)}), flush=True)


if __name__ == "__main__":
    main()
