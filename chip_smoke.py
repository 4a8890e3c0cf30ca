#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (videoquery_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # from the root of a checkout

Phases, each printing its own lines; any failure exits non-zero:

1. device   the card (nvidia-smi name and power limit), torch and CUDA.
2. build    K1, K2, K3, T1 and T2 (kernels/csrc/{query_kernel,tvl1_level,
            window_warp,inception_block,roll}.cu) compiled by nvcc for sm_90a,
            one process each, all at once.
2b. cuda    the `cuda` tests, which import no jax: python -m pytest
            --noconftest -p no:cacheprovider -m cuda
            tests/test_torch_cuda_kernels.py; every test must pass, none
            skip.
3. k1       K1 against its plain PyTorch version on the card at Q=16, S=2,
            K=3, D=1024, N=65,536+77 (ragged edge), ~25% mask holes: f32 and
            bf16 index, both epilogues, both target modes; rtol 1e-5 /
            atol 1e-6, counts and top-k ids equal; query 0 alone bitwise
            equal to query 0 inside launches of Q = 2, 3, 8, 16 (and 70,
            which the wrapper splits); then D = 72 and 100 at N = 1003, Q = 5
            (a part-filled last k-step, the unvectorised staging).
4. broker   the broker round on the fixture CSVs: DBLoader into an
            in-process FakeAPI, then new -> revise -> finalize through
            compute_matches on the card (seed 42), held against the port's
            exact float64 path round by round.
5. scale    (a) 8 concurrent revise rounds over a 100,000-segment f32 search
            set (resident banded path), p50 of 5; (b) 16 queries x 1,000,000
            segments bf16 through fused_query_topk(k=20), p50 of 10, kernel
            and plain version; (c) the avg+counts pass with 8 f32 targets
            over the same index, p50 of 10, checked on 65,536 clips.
6. k3       K3 (window warp) against its plain version on the card: 400 pairs
            at the camera grid 48x64 and the flow grid 128x128 (d=4) and at a
            64-wide grid (the four-pixel vector body), and 100 at 30x101 (the
            scalar body), separable and full, rough random flow beyond the
            clamp; rtol 1e-5 / atol 1e-6. The host cost of a call at 48x64.
7. k2       K2 (TV-L1 level) against its plain version on 400 key pairs at
            each production level (128, 64, 32, 16 px square; window
            max(2, round(6 * 0.5**level)); PRODUCTION_TVL1.at_level), at
            the rescue window d=12 and on 16 pairs at 256x384 (the tiles
            route), then warp modes 1 and 2 (the image's gradients through a
            separable and a full warp) at 16 x 8x64, 16 x 20x100 and 64 x
            128x128; at most 1e-3 px of flow apart. For each production case
            the plan (route, band rows, cluster, shared bytes) and the device
            launches of a call, counted by torch.profiler and held to the
            plan's count; the time, and in the log the parent commit's time
            beside it (PARENT_K2_MS).
8. extract  a synthetic 340x256 video (pan, zoom, a moving object; 8 full
            10 s clips and a tail) through the extraction CLI's code path
            (random seeded TSN, production config, warped flow) into a CSV
            tree; the port's loader ingests it and the broker runs new ->
            revise -> finalize on it on the card. K1, K2 and K3 must launch.
            One clip's 125 quantised flow pairs from the card equal the
            plain versions' on the CPU in >= 99.9% of bytes, never more than
            1 apart. p50 of an 8-clip batch, and its flow with the kernels
            and with the plain versions. The CLI again with --dtype bfloat16:
            the loader ingests its CSVs, and its signatures, and those of an
            8-clip batch in bf16 (timed too), are within the JAX package's
            bf16 criterion of the f32 ones (mean |diff| / mean |f32| < 0.1,
            tests/test_nn.py). The bf16 CLI run must launch T1 (every
            stride-1 block of the bf16 nets); T1's launches per bf16 batch
            (48: 8 blocks x 3 nets x 2 streams). The bf16 batch timed with
            the T1 route and with the unfused route (each block a chain of
            convs, pools and a concat), in turns. torch.profiler traces of
            the rgb stream's 3 nets on 200 ticks (f32, bf16) and of one bf16
            batch: device busy time, idle share, the top kernels, the
            device time by kind (T1, cuDNN convs, pools, casts and
            elementwise passes, concats), K2's, K3's and T1's device time
            and device launches.
8b. ingest the operator's ingest path, in phase 8's directory: a second
            synthetic 340x256 video (4 full clips and a tail) beside phase 8's;
            the extraction CLI on both with 2 decode worker processes, the
            compact uploads (host gray, host crop, YUV 4:2:0) and bf16
            networks, which must launch K2, K3 and T1; its CSVs equal, byte
            for byte, those of Extractor.extract_video_stream in this process
            (same config and weights), whose signatures equal extract_frames
            over the whole decoded video bit for bit; the compact CSVs
            against phase 8's full-frame bf16 ones (least cosine: rgb >
            0.999, flow > 0.97, the JAX package's floors); the loader with
            --shard_out --no_api, the shards onto the card in f32 and bf16
            equal to load_index of the CSVs bit for bit, and K1's top-20 on
            both the same ids. Clips/s file -> CSVs for one process streaming
            and for 2 workers; one traced streaming run (device busy time,
            idle share, top kernels); the compact payload's MB a clip, the
            shards' write and load times: a JSON line {"ingest": ...} before
            the card's line.
9. t1       T1 (fused stride-1 Inception block) against its plain version
            at all 8 stride-1 block shapes, 3 members x 4 images, and in the
            extraction path's geometry (one member, its own x, 25 images,
            non-zero biases): f32 within rtol 1e-4 / atol 1e-5 (only the
            order of sums differs); bf16 with >= 99% of outputs within one
            bf16 ulp and max |diff| <= 1/64 of the largest output; at most
            3 device launches a bf16 call (torch.profiler; a trace may miss
            one). The conv-rounding tool (videoquery_torch.tools.
            conv_rounding): one bf16 forward of 200 seeded 224x224 frames
            with non-zero biases; each of the 13 convs outside T1 (the stem's
            three, widened to f32 under TF32, and the stride-2 blocks' ten)
            equals the f32 conv rounded once on >= 99.9% of outputs at the
            input the forward gives it. Then the A/B tool
            (videoquery_torch.tools.inception_block_bench) at 1 x 200 (the
            path) and 3 x 200 images in bf16, non-zero biases: T1 against its
            plain version at that shape by the bf16 criterion, every block;
            T1 and the same block as a bare cuDNN bf16 chain, ms per block
            and in total.
10. t2      the roll repro tool (videoquery_torch.tools.roll_repro): T2 with
            the shift read from device memory, 12 cases, each equal to
            torch.roll; T2 and torch.roll over 100 back-to-back calls, and
            the host cost of each piece of a T2 call.
11. flow quality  the flow-quality gate (videoquery_torch.tools.
            flow_quality) at seed 0: its default table (corpus v4, 40 clips
            of 30 frames at 128x176: the full-resolution gather baseline and
            the K2/K3 rows at full, half and quarter resolution), then
            --final --corpus 3 --scale 2 (24 clips at 256x352, five
            production candidates on K2/K3), f32 random seeded nets; every
            row's retrieval and EPE (mean, p90, object, background) finite,
            the production row of --final at EPE <= 0.26 (the JAX package's
            gate); K2's route at each row's grids; K2's and K3's launches in
            each run (counts zeroed just before it); then K2 and K3 against
            their plain versions on the operands of their first call at
            each caller, shape and window in those runs (K2's tiles route
            at 128x176 and K3's affine residual among them); a JSON line
            {"flow_quality": ...} before the card's line.
12. scale-out  a NCCL world of one rank on the card (a file:// store in the
            run's temporary directory) and make_mesh("cuda"); phase 5b's index
            again (1,000,000 segments bf16, 12.3 GB, the same seed) through
            ShardedSearch (impl "pallas": K1's scores epilogue and torch.topk
            on the rank's shard, the all-gather of the [Q, k] candidates, the
            merge) at Q=16, k=20: ids equal to fused_query_topk's, values
            bitwise; the same index as 4 row shards in this process, each
            shard's K1 top-20 (shard 0's against the plain version) merged
            and held to the unsharded top-20 (ids equal, values within rtol
            1e-5 / atol 1e-6; whether bitwise is printed); the p50 of 10
            sharded calls beside K1 + top-k + the download, in turns; K1's
            launches on the sharded path.
13. train   TSNTrainer under DDP on that world: the rgb stream (full
            BN-Inception at 224x224, 101 classes, 3 segments, dropout 0.8,
            learning rate 0.01), 10 steps on one seeded batch of 32 videos
            (96 images), the loss must fall; the flow stream (10 channels)
            for 3 steps; at 2 videos and dropout 0 the card's first step
            against the CPU's (loss rtol 1e-5, every weight rtol 2e-4 / atol
            2e-6, tests/test_distributed.py's tolerances); a checkpoint saved
            after that step, loaded into a fresh trainer, whose next step
            equals continuing bit for bit. The step p50, images/s and the
            peak of torch.cuda.max_memory_allocated; a JSON line
            {"scale_out": ..., "train": ...} before the card's line.

Beside each kernel's time the kernels line gives its bound on an H100 SXM
(the larger of its compulsory bytes over 3.35 TB/s and its operations over
989 TFLOP/s bf16 tensor-core or 67 TFLOP/s f32 peak) and, where one exists,
the time of a PyTorch library call for the same work.

The second-to-last line is a JSON object describing each kernel; the last
is {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
Without CUDA, or without the repository beside this file, it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import random
import re
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
FIXTURES = os.path.join(REPO, "tests", "data", "features",
                        "stock-video-clips_features")
K1_SOURCE = "videoquery_torch/kernels/csrc/query_kernel.cu"
K1_REPLACES = "videoquery/kernels/query_pallas.py:35"
K2_SOURCE = "videoquery_torch/kernels/csrc/tvl1_level.cu"
K2_REPLACES = "videoquery/kernels/tvl1_pallas.py:59"
K3_SOURCE = "videoquery_torch/kernels/csrc/window_warp.cu"
K3_REPLACES = "videoquery/kernels/tvl1_pallas.py:263"
T1_SOURCE = "videoquery_torch/kernels/csrc/inception_block.cu"
T1_REPLACES = "tools/inception_pallas.py:66"
T2_SOURCE = "videoquery_torch/kernels/csrc/roll.cu"
T2_REPLACES = "tools/mosaic_roll_repro.py:26"
PEAK_BYTES = 3.35e12                        # H100 SXM HBM3, bytes/s
PEAK_BF16, PEAK_F32 = 989e12, 67e12         # tensor-core bf16; f32 without
FLOW_ATOL_PX = 1e-3  # K2 vs plain: same operations in the same order
# K2 per phase-7 case (pairs x height x width, window) on the parent commit's
# kernel, CUDA events, mean of 5: one run of that commit's chip_smoke.py
# phase 7 on an NVIDIA H100 80GB HBM3, 700.00 W (PERF.md)
PARENT_K2_MS = {"400x128x128_d6": 4.470, "400x64x64_d3": 2.270, "400x32x32_d2": 3.420,
                "400x16x16_d2": 1.949, "125x128x128_d12": 1.560}
RTOL, ATOL = 1e-5, 1e-6  # tests/test_pallas.py: only the order of sums differs
STREAMS = ("rgb", "warped_optical_flow")


def log(msg: str) -> None:
    print(msg, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(build_log: str) -> list[str]:
    """One line per compiled kernel instance: registers and spills, from
    nvcc -Xptxas -v (K1: query_kernel<queries per thread, scores> for an f32
    index, query_mma_kernel<n-tiles, target terms, scores> for a bf16 one)."""
    out, name, spill = [], None, ""
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if m:
            k1 = re.search(r"query_kernelILi(\d+)ELb(\d)E", m.group(1))
            k1m = re.search(r"query_mma_kernelILi(\d+)ELi(\d)ELb(\d)E", m.group(1))
            if k1:
                epi = "scores" if k1.group(2) == "1" else "avg+counts"
                name = f"query_kernel<f32, {k1.group(1)} queries/thread, {epi}>"
            elif k1m:
                epi = "scores" if k1m.group(3) == "1" else "avg+counts"
                name = (f"query_mma_kernel<bf16, {k1m.group(1)} n-tiles of 8 queries, "
                        f"{k1m.group(2)} target terms, {epi}>")
            elif "f32_conv_kernel" in m.group(1):
                t1 = re.search(r"f32_conv_kernelILi(\d)E", m.group(1))
                mode = ("1x1", "3x3", "ave pool + 1x1", "max pool + 1x1")[int(t1.group(1))]
                name = f"T1 f32_conv_kernel<{mode}>"
            elif "xtile_kernel" in m.group(1) or "conv3x3_kernel" in m.group(1):
                name = "T1 " + ("xtile_kernel" if "xtile_kernel" in m.group(1)
                                else "conv3x3_kernel") + " (bf16, wgmma)"
            else:  # "..._cu_<hash>9pd_kernelE...": the identifier after a length
                found = re.findall(r"\d(tvl1_band_kernel|warp4_kernel|[a-z]+(?:_[a-z]+)*_kernel)"
                                   r"(?:ILi(\d)E)?E",
                                   m.group(1))
                name = ((found[-1][0] + (f"<mode {found[-1][1]}>" if found[-1][1] else ""))
                        if found else m.group(1))
        elif name and "spill stores" in line:
            spill = line.strip()
        elif name and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            out.append(f"{name}: {regs.group(1) if regs else '?'} registers; {spill}")
            name = None
    return out


def p50_ms(fn, repeats: int, warmup: int = 1) -> float:
    """Median wall time of fn() in ms, synchronised on both sides."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def check_close(name: str, got, want, errs: list) -> None:
    import torch

    err = float((got - want).abs().max()) if got.numel() else 0.0
    errs.append(err)
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: max abs err {err:.3e} beyond rtol {RTOL} atol {ATOL}")


# -- phase 2b -----------------------------------------------------------------

CUDA_TESTS = ("tests/test_torch_cuda_kernels.py",)


def phase_cuda_tests() -> int:
    """The `cuda` tests in a pytest of their own, without the repository's
    conftest (it imports jax); returns the number that passed. Fails unless
    pytest exits 0 with every test passed and none skipped."""
    cmd = [sys.executable, "-m", "pytest", "--noconftest", "-p", "no:cacheprovider", "-q",
           "-m", "cuda", *CUDA_TESTS]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True, timeout=900)
    lines = [ln for ln in r.stdout.strip().splitlines() if ln.strip()]
    summary = lines[-1] if lines else ""
    counts = dict((k, int(n)) for n, k in re.findall(r"(\d+) (\w+)", summary))
    passed = counts.pop("passed", 0)
    others = {k: n for k, n in counts.items() if not k.startswith("warning")}
    log(f"[cuda] {' '.join(cmd[1:])}: {summary} ({time.perf_counter() - t0:.1f} s)")
    if r.returncode != 0 or not passed or others:
        raise AssertionError(f"the cuda tests did not all pass (exit {r.returncode}):\n"
                             + "\n".join(lines[-40:]) + r.stderr[-2000:])
    log(f"[cuda] {passed} cuda tests passed, none skipped")
    return passed


# -- phase 3 ------------------------------------------------------------------

def phase_k1(dev) -> float:
    """K1 vs its plain version, both epilogues, both index and target types;
    returns the largest absolute error seen."""
    import torch

    from videoquery_torch.kernels import query as k1

    q, s, k, n, d = 16, 2, 3, 65_536 + 77, 1024
    g = torch.Generator(device=dev).manual_seed(1)
    # unit-scale embeddings (entries ~ N(0, 1/D)), as the CNN features compare
    feats32 = torch.randn((s, k, n, d), generator=g, device=dev) / 32.0
    mask = torch.rand((s, k, n), generator=g, device=dev) > 0.25
    targets = torch.randn((q, s, k, d), generator=g, device=dev) / 32.0
    tmask = torch.rand((q, s, k), generator=g, device=dev) > 0.1
    tmask[0] = True
    weights = torch.ones((q, s), device=dev)
    weights[:, 1] = 1.5
    errs: list[float] = []
    for fdt in (torch.float32, torch.bfloat16):
        feats = feats32.to(fdt)
        for tdt in (torch.float32, fdt) if fdt != torch.float32 else (torch.float32,):
            tag = f"feats {str(fdt)[6:]} targets {str(tdt)[6:]}"
            avg, cnt = k1.query_k1(feats, mask, targets, tmask, target_dtype=tdt)
            avg_r, cnt_r = k1.query_k1_reference(feats, mask, targets, tmask,
                                                 target_dtype=tdt)
            check_close(f"avg ({tag})", avg, avg_r, errs)
            assert torch.equal(cnt, cnt_r), f"counts differ ({tag})"
            sc = k1.query_k1(feats, mask, targets, tmask, weights, target_dtype=tdt)
            sc_r = k1.query_k1_reference(feats, mask, targets, tmask, weights,
                                         target_dtype=tdt)
            finite = sc_r > -1e29
            assert torch.equal(finite, sc > -1e29), f"invalid clips differ ({tag})"
            check_close(f"scores ({tag})", sc[finite], sc_r[finite], errs)
            ids = torch.topk(sc, 20).indices
            ids_r = torch.topk(sc_r, 20).indices
            assert torch.equal(ids, ids_r), f"top-k ids differ ({tag})"
            # Q-independence, bitwise, for both epilogues
            alone_avg, alone_cnt = k1.query_k1(feats, mask, targets[:1], tmask[:1],
                                               target_dtype=tdt)
            alone_sc = k1.query_k1(feats, mask, targets[:1], tmask[:1], weights[:1],
                                   target_dtype=tdt)
            for qb in (2, 3, 8, 16, 70):
                rep = (qb + q - 1) // q
                tb = targets.repeat(rep, 1, 1, 1)[:qb].contiguous()
                tmb = tmask.repeat(rep, 1, 1)[:qb].contiguous()
                wb = weights.repeat(rep, 1)[:qb].contiguous()
                a_b, c_b = k1.query_k1(feats, mask, tb, tmb, target_dtype=tdt)
                s_b = k1.query_k1(feats, mask, tb, tmb, wb, target_dtype=tdt)
                assert torch.equal(a_b[0], alone_avg[0]), f"avg of Q={qb} != Q=1 ({tag})"
                assert torch.equal(c_b[0], alone_cnt[0]), f"counts of Q={qb} != Q=1 ({tag})"
                assert torch.equal(s_b[0], alone_sc[0]), f"scores of Q={qb} != Q=1 ({tag})"
                if qb == 70:  # the second launch of the split holds query 64
                    assert torch.equal(a_b[64], alone_avg[0]), f"chunked Q=70 ({tag})"
            log(f"[k1] {tag}: avg/counts, scores and top-20 ids agree; "
                f"query 0 bitwise equal alone and in Q=2,3,8,16,70")
    # depths off the 64-deep slices: D = 72 ends in a part-filled 16-deep
    # step, D = 100 takes the element-by-element staging (D % 8 != 0)
    for dd in (72, 100):
        f32 = torch.randn((s, k, 1003, dd), generator=g, device=dev) / 10.0
        m = mask[:, :, :1003].contiguous()
        t = torch.randn((5, s, k, dd), generator=g, device=dev) / 10.0
        for fdt, tdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                         (torch.bfloat16, torch.bfloat16)):
            f = f32.to(fdt)
            for w in (None, weights[:5]):
                got = k1.query_k1(f, m, t, tmask[:5], w, target_dtype=tdt)
                want = k1.query_k1_reference(f, m, t, tmask[:5], w, target_dtype=tdt)
                one = k1.query_k1(f, m, t[:1], tmask[:1], None if w is None else w[:1],
                                  target_dtype=tdt)
                if w is None:
                    assert torch.equal(got[1], want[1]), f"counts differ (D={dd})"
                    got, want, one = got[0], want[0], one[0]
                check_close(f"D={dd} feats {str(fdt)[6:]} targets {str(tdt)[6:]}",
                            got, want, errs)
                assert torch.equal(one[0], got[0]), f"Q=1 != Q=5 (D={dd})"
    log("[k1] D = 72 and 100, N = 1003, Q = 5: all index and target types agree, "
        "query 0 bitwise equal alone")
    torch.cuda.synchronize()
    log(f"[k1] max abs err vs plain version: {max(errs):.3e} "
        f"(rtol {RTOL}, atol {ATOL})")
    return max(errs)


# -- phase 4 ------------------------------------------------------------------

def run_fixture_lifecycle(device, exact: bool, report_dir: str, root: str = FIXTURES):
    """new -> revise -> finalize over a feature-CSV tree (the fixtures by
    default); returns the states after each round, the matched clip ids of
    each round and the API."""
    from videoquery_torch.testing.fake_api import FakeAPI, FakeClient
    from videoquery_torch.core.config import HyperParams
    from videoquery_torch.service.compute_matches import compute_matches
    from videoquery_torch.service.loader import DBLoader
    from videoquery_torch.service.repository import APIRepository

    api = FakeAPI()
    n_rows = DBLoader(FakeClient(api)).load_tree(root)
    clip_ids = sorted(api.video_clips)
    video_id = next(iter(api.videos))
    ref = next(c for c in clip_ids if api.video_clips[c]["clip"] == 1)
    search = api.add_search_set("all", clip_ids)
    query = api.add_query("smoke", video_id, 1, ref, search["id"],
                          max_matches_for_review=10)
    repo = APIRepository(FakeClient(api), "fake://")

    def poll():
        compute_matches(repo, HyperParams(), seed=42, report_dir=report_dir,
                        exact=exact, device=device)

    def latest_matches():
        r = max((r for r in api.query_results.values() if r["query"] == query["id"]),
                key=lambda r: r["round"])
        return sorted((m for m in api.matches.values() if m["query_result"] == r["id"]),
                      key=lambda m: m["video_clip"])

    states, rounds = [], []
    poll()
    states.append(api.queries[query["id"]]["process_state"])
    ms = latest_matches()
    rounds.append([m["video_clip"] for m in ms])
    for m in ms[:3]:
        api.set_user_match(m["id"], True)
    api.request_revision(query["id"])
    poll()
    states.append(api.queries[query["id"]]["process_state"])
    ms = latest_matches()
    rounds.append([m["video_clip"] for m in ms])
    api.set_user_match(ms[0]["id"], True)
    api.request_finalize(query["id"])
    poll()
    states.append(api.queries[query["id"]]["process_state"])
    rounds.append([m["video_clip"] for m in latest_matches()])
    return states, rounds, api, query["id"], n_rows


def phase_broker(dev) -> int:
    """The main path on the card; returns K1 launches made by it."""
    from videoquery_torch.kernels import query as k1

    with tempfile.TemporaryDirectory() as tmp_exact, \
            tempfile.TemporaryDirectory() as tmp:
        want_states, want_rounds, _, _, _ = run_fixture_lifecycle(
            "cpu", exact=True, report_dir=tmp_exact)
        k1.LAUNCHES = 0
        t0 = time.perf_counter()
        states, rounds, api, qid, n_rows = run_fixture_lifecycle(
            dev, exact=False, report_dir=tmp)
        launches = k1.LAUNCHES
        dt = time.perf_counter() - t0
    log(f"[broker] loaded {n_rows} feature rows from {FIXTURES}")
    log(f"[broker] states {states}, matches per round {[len(r) for r in rounds]}, "
        f"K1 launches {launches}, {dt:.2f} s incl. ingest")
    assert states == [4, 4, 7], states
    assert all(rounds), "a round selected no matches"
    assert qid in api.uploaded_reports, "no final report uploaded"
    assert "min score for a match:" in api.uploaded_reports[qid]
    assert launches > 0, "the broker round never launched K1"
    assert rounds == want_rounds and states == want_states, (
        f"device f32 rounds {rounds} != exact f64 rounds {want_rounds}")
    log("[broker] each device round selects the same clips as the exact f64 path")
    return launches


# -- phase 5 ------------------------------------------------------------------

def phase_rounds(dev, n_segments=100_000, q=8, n_reviewed=20, repeats=5) -> dict:
    """Q concurrent revise rounds over a resident f32 search set."""
    import numpy as np
    import torch

    from videoquery_torch.core.config import HyperParams
    from videoquery_torch.index.store import FeatureIndex
    from videoquery_torch.kernels import query as k1
    from videoquery_torch.search.engine import (SearchEngine, optimize_many,
                                                round_scores_many)
    from videoquery_torch.search.scoring import ensemble_similarities_batched
    from videoquery_torch.search.selection import select_clips_to_review

    hp = HyperParams()
    d = 1024
    g = torch.Generator(device=dev).manual_seed(0)
    feats = torch.randn((2, 3, n_segments, d), generator=g, device=dev).mul_(0.03)
    index = FeatureIndex(np.arange(1, n_segments + 1, dtype=np.int64), feats,
                         torch.ones((2, 3, n_segments), dtype=torch.bool, device=dev),
                         STREAMS, (1, 2, 3), hp.feature_name)
    rng = np.random.default_rng(0)
    targets = [{st: {k: (rng.normal(size=d) * 0.03).tolist() for k in (1, 2, 3)}
                for st in STREAMS} for _ in range(q)]
    labels = [{int(c): float(rng.integers(0, 2))
               for c in rng.choice(n_segments, n_reviewed, replace=False) + 1}
              for _ in range(q)]
    engine = SearchEngine(index)

    def select(scores, h):
        return select_clips_to_review(scores, {}, 1, h.threshold, 20,
                                      hp.near_miss_default, rng=random.Random(42))

    def one_round():
        tables = engine.compute_similarities_multi(targets, resident=True)
        hps = [h for h, _ in optimize_many(tables, labels, hp)]
        specs = [{"weights": h.weights, "threshold": h.threshold,
                  "near_miss": hp.near_miss_default, "keep_ids": [1],
                  "user_match_ids": [], "finalize": False} for h in hps]
        scores = round_scores_many(tables, specs)
        return tables, hps, [select(sc if sc is not None else t.to_table().scores(h.weights), h)
                             for t, h, sc in zip(tables, hps, scores)]

    tables, hps, picks = one_round()
    assert all(picks), "a round selected nothing"
    # the resident banded round selects exactly what the full download does
    full = tables[0].to_table()
    h_full, _ = full.optimize(labels[0], hp)
    assert h_full == hps[0]
    assert select(full.scores(h_full.weights), h_full) == picks[0]
    round_ms = p50_ms(one_round, repeats, warmup=0)
    t = torch.from_numpy(np.stack([index.target_arrays_host(x)[0] for x in targets]
                                  ).astype(np.float32)).to(dev)
    tm = torch.ones((q, 2, 3), dtype=torch.bool, device=dev)
    avg, cnt = ensemble_similarities_batched(t, tm, feats, index.mask)
    avg_r, cnt_r = k1.ensemble_similarities_batched_reference(t, tm, feats, index.mask)
    assert torch.equal(cnt, cnt_r), "counts differ at 8 x 100k"
    errs: list[float] = []
    check_close("avg at 8 x 100k", avg, avg_r, errs)
    del avg, cnt, avg_r, cnt_r
    sim_ms = p50_ms(lambda: ensemble_similarities_batched(t, tm, feats, index.mask), 10)
    sim_plain_ms = p50_ms(lambda: k1.ensemble_similarities_batched_reference(
        t, tm, feats, index.mask), 10)
    log(f"[scale] {q} concurrent revise rounds over {n_segments} f32 segments: "
        f"p50 {round_ms:.2f} ms per round of {q} ({round_ms / q:.2f} ms/query)")
    log(f"[scale] its similarity pass (avg+counts, Q={q}): K1 p50 {sim_ms:.3f} ms, "
        f"plain p50 {sim_plain_ms:.3f} ms")
    del feats, index, engine, tables
    return {"round_ms": round_ms, "sim_ms": sim_ms, "sim_plain_ms": sim_plain_ms,
            "err": errs[0]}


def query_world(dev, n_segments: int, q: int, d: int = 1024):
    """Phase 5b's query world, from seed 2: a bf16 index [2, 3, N, D] of
    unit-scale embeddings (every member present), Q f32 targets, weights
    1.0 / 1.5. Returns (feats, mask, targets, tmask, weights)."""
    import torch

    g = torch.Generator(device=dev).manual_seed(2)
    feats = torch.randn((2, 3, n_segments, d), generator=g, device=dev,
                        dtype=torch.bfloat16).mul_(1.0 / 32.0)  # exact in bf16
    mask = torch.ones((2, 3, n_segments), dtype=torch.bool, device=dev)
    targets = torch.randn((q, 2, 3, d), generator=g, device=dev) / 32.0
    tmask = torch.ones((q, 2, 3), dtype=torch.bool, device=dev)
    weights = torch.ones((q, 2), device=dev)
    weights[:, 1] = 1.5
    return feats, mask, targets, tmask, weights


def phase_query(dev, n_segments=1_000_000, q=16, k=20, repeats=10) -> dict:
    """16 queries over 1M bf16 segments through fused_query_topk; then the
    engine's avg+counts pass (f32 targets) at Q=8 over the same index."""
    import torch

    from videoquery_torch.kernels import query as k1
    from videoquery_torch.search.scoring import ensemble_similarities_batched

    feats, mask, targets, tmask, weights = query_world(dev, n_segments, q)
    d = feats.shape[3]
    gb = feats.numel() * feats.element_size() / 1e9
    vals, ids = k1.fused_query_topk(feats, mask, targets, tmask, weights, k=k)
    vals_r, ids_r = torch.topk(k1.fused_query_scores_reference(
        feats, mask, targets, tmask, weights), k)
    assert torch.isfinite(vals).all() and vals.shape == (q, k)
    errs: list[float] = []
    check_close("top-k values at 16 x 1M", vals, vals_r, errs)
    same_ids = float((ids == ids_r).float().mean())
    kern = p50_ms(lambda: k1.fused_query_topk(feats, mask, targets, tmask, weights, k=k),
                  repeats)
    plain = p50_ms(lambda: torch.topk(k1.fused_query_scores_reference(
        feats, mask, targets, tmask, weights), k), repeats)
    kern2 = p50_ms(lambda: k1.fused_query_topk(feats, mask, targets, tmask, weights, k=k),
                   repeats)
    # the library yardstick: one bf16 torch.matmul of the same products
    # (no mask, no per-stream average, no score, no top-k)
    fk = feats.reshape(6, n_segments, d)
    tk = targets.to(torch.bfloat16).permute(1, 2, 3, 0).reshape(6, d, q).contiguous()
    lib = p50_ms(lambda: torch.matmul(fk, tk), repeats)
    # the same split in device time (CUDA events): the scores pass alone,
    # the top-k after it, and the library call
    scores = k1.fused_query_scores(feats, mask, targets, tmask, weights)
    split = {"scores_ms": cuda_ms(lambda: k1.fused_query_scores(
                 feats, mask, targets, tmask, weights)),
             "topk_ms": cuda_ms(lambda: torch.topk(scores, k)),
             "library_events_ms": cuda_ms(lambda: torch.matmul(fk, tk))}
    del scores
    log(f"[scale] {q} queries x {n_segments} bf16 segments ({gb:.1f} GB index), "
        f"top-{k}: K1 p50 {kern:.3f} ms (again {kern2:.3f} ms), plain p50 "
        f"{plain:.3f} ms, torch.matmul of the bf16 products p50 {lib:.3f} ms; "
        f"top-k values agree, ids agree {same_ids:.3f}")
    log(f"[scale] K1 effective index read rate: {gb / (kern / 1e3):.0f} GB/s")
    log(f"[scale] CUDA events, mean of 10: K1 scores pass {split['scores_ms']:.3f} ms "
        f"({gb / (split['scores_ms'] / 1e3):.0f} GB/s), torch.topk after it "
        f"{split['topk_ms']:.3f} ms, torch.matmul of the bf16 products "
        f"{split['library_events_ms']:.3f} ms")
    # compulsory bytes: index, mask, targets and weights read once, the
    # top-k written once; operations: one multiply-add per index value and query
    nbytes = (feats.numel() * 2 + mask.numel() + targets.numel() * 4 + weights.numel() * 4
              + q * k * 12)
    flops = 2.0 * q * feats.numel()
    del fk

    # the busy broker's similarity pass: K1's avg+counts epilogue with f32
    # targets (three bf16 terms a target) at Q=8 over the same index, held
    # against the plain version on the first 65,536 clips
    q8, ns = 8, 65_536
    t8, tm8 = targets[:q8].contiguous(), tmask[:q8].contiguous()
    avg, cnt = ensemble_similarities_batched(t8, tm8, feats, mask)
    avg_r, cnt_r = k1.ensemble_similarities_batched_reference(
        t8, tm8, feats[:, :, :ns].contiguous(), mask[:, :, :ns].contiguous())
    assert avg.shape == (q8, 2, n_segments) and torch.isfinite(avg).all()
    assert torch.equal(cnt[:, :, :ns], cnt_r), "counts differ at 8 x 1M bf16"
    check_close("avg at 8 x 1M bf16, f32 targets", avg[:, :, :ns], avg_r, errs)
    del avg, cnt, avg_r, cnt_r
    sim8 = p50_ms(lambda: ensemble_similarities_batched(t8, tm8, feats, mask), repeats)
    # index, mask, targets and tmask read once, avg and counts written once;
    # one f32 multiply-add per index value and query
    sim8_bound = bound(feats.numel() * 2 + mask.numel() + t8.numel() * 4 + tm8.numel()
                       + q8 * 2 * n_segments * 8, 2.0 * q8 * feats.numel(), PEAK_F32)
    log(f"[scale] avg+counts, {q8} f32 targets x {n_segments} bf16 segments: K1 p50 "
        f"{sim8:.3f} ms (bound {sim8_bound['bound_ms']:.3f} ms, "
        f"{sim8_bound['bound_by']}); agrees with the plain version on {ns} clips")
    del feats
    return {"query_ms": kern, "query_plain_ms": plain, "err": max(errs), "library_ms": lib,
            "avg_counts_ms_1m_bf16_q8": sim8, "avg_counts_bound_ms_1m_bf16_q8":
            sim8_bound["bound_ms"], **split, **bound(nbytes, flops, PEAK_BF16)}


# -- phase 6 ------------------------------------------------------------------

def bound(nbytes: float, flops: float, peak_flops: float) -> dict:
    """The least time the card could take: the larger of the compulsory
    bytes over the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / peak_flops
    return {"bound_ms": max(t_bytes, t_ops) * 1e3,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def cuda_ms(fn, repeats: int = 10) -> float:
    """Mean device time of fn() in ms over `repeats` launches (CUDA events),
    after one warm-up call."""
    import torch

    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(repeats):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / repeats


def trace(fn, top: int = 8, warm: bool = True) -> dict:
    """One torch.profiler trace of fn() (after one untraced call if `warm`):
    traced wall ms (host clock around a synchronised call), device busy ms
    (the union of kernel intervals), the idle share, and the `top` kernels
    by device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy, end = 0.0, float("-inf")
    for e in sorted(kernels, key=lambda e: e.time_range.start):
        if e.time_range.end > end:
            busy += e.time_range.end - max(e.time_range.start, end)
            end = e.time_range.end
    by_name: dict[str, tuple[float, int]] = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return {"wall_ms": wall, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / 1e3 / wall if kernels else None,
            "top": [(name[:90], ms, n) for name, (ms, n) in ranked],
            "by_name": by_name}


# the device kernels of K3 (window_warp.cu) as the profiler names them (with
# "void " before a template's name only; K2's: tvl1_level.DEVICE_KERNELS)
K3_KERNELS = re.compile(r"^(?:void )?\(anonymous namespace\)::warp4?_kernel\b")
# T1's bf16 kernels (inception_block.cu)
T1_KERNELS = re.compile(r"^(?:void )?\(anonymous namespace\)::(xtile|conv3x3)_kernel\b")
# the device time of the networks by kind, first match wins
NET_KINDS = (("T1", T1_KERNELS),
             ("cuDNN convs", re.compile(r"conv|xmma|implicit|cudnn|fprop|sm90_|wgrad|dgrad",
                                        re.I)),
             ("pools", re.compile(r"pool", re.I)),
             ("concats", re.compile(r"CatArray", re.I)),
             ("casts and elementwise", re.compile(r"elementwise|copy|reduce", re.I)))


def kernel_time(tr: dict, pattern) -> tuple[float, int]:
    """Device ms and launches of the traced kernels whose names match."""
    hits = [v for name, v in tr["by_name"].items() if pattern.search(name)]
    return sum(ms for ms, _ in hits), sum(n for _, n in hits)


def by_kind(tr: dict) -> dict:
    """{kind: (device ms, launches)} of a trace's kernels (NET_KINDS, the
    rest "other")."""
    out = {kind: (0.0, 0) for kind, _ in NET_KINDS}
    out["other"] = (0.0, 0)
    for name, (ms, n) in tr["by_name"].items():
        kind = next((k for k, pat in NET_KINDS if pat.search(name)), "other")
        out[kind] = (out[kind][0] + ms, out[kind][1] + n)
    return out


def log_trace(tag: str, what: str, tr: dict) -> None:
    idle = "not measured" if tr["idle_share"] is None else f"{tr['idle_share']:.3f}"
    log(f"[{tag}] trace of {what}: traced wall {tr['wall_ms']:.1f} ms, device busy "
        f"{tr['busy_ms']:.1f} ms, idle share {idle}")
    for name, ms, n in tr["top"]:
        log(f"[{tag}]   {ms:8.2f} ms in {n:4d} launches: {name}")
    log(f"[{tag}]   by kind: " + ", ".join(f"{k} {ms:.2f} ms in {n} launches"
                                          for k, (ms, n) in by_kind(tr).items()))


def smooth_frames(n: int, h: int, w: int, dev, seed: int):
    """[n, h, w] f32 textures in [0, 1] (box-blurred noise) on the card."""
    import torch
    import torch.nn.functional as F

    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.rand((n, 1, h, w), generator=g, device=dev)
    x = F.avg_pool2d(F.pad(x, (2, 2, 2, 2), mode="replicate"), 5, 1)
    x = x - x.amin(dim=(2, 3), keepdim=True)
    return (x / x.amax(dim=(2, 3), keepdim=True))[:, 0].contiguous()


def phase_k3(dev) -> dict:
    """K3 vs its plain version at the production shapes (the vector body,
    w % 4 == 0) and at a ragged width (the scalar body); rough flow. Then
    the host cost of a call at the camera's 48x64."""
    import torch

    from videoquery_torch.kernels import window_warp as k3

    errs: list[float] = []
    times = {}
    g = torch.Generator(device=dev).manual_seed(3)
    for (n, h, w) in ((400, 48, 64), (400, 128, 128), (400, 64, 64), (100, 30, 101)):
        img = smooth_frames(n, h, w, dev, seed=h + w)
        u = (torch.rand((n, h, w), generator=g, device=dev) * 12 - 6).contiguous()
        v = (torch.rand((n, h, w), generator=g, device=dev) * 12 - 6).contiguous()
        for sep in (True, False):
            got = k3.window_warp(img, u, v, 4, sep)
            want = k3.window_warp_reference(img, u, v, 4, sep)
            check_close(f"K3 {n}x{h}x{w} separable={sep}", got, want, errs)
            if (h, w) == (128, 128) and sep:
                times["ms"] = cuda_ms(lambda: k3.window_warp(img, u, v, 4, True))
                times["plain_ms"] = cuda_ms(
                    lambda: k3.window_warp_reference(img, u, v, 4, True))
                # img, u, v read once, out written once; ~48 f32 operations a
                # pixel (clamps, floors, 4 triangle weights, 3 two-tap lerps)
                times.update(bound(4.0 * img.numel() * 4, 48.0 * img.numel(), PEAK_F32))
            if (h, w) == (128, 128) and not sep:
                # the library call for full mode: bilinear F.grid_sample with
                # edge-clamped borders on the clamped flow's sample grid
                gy, gx = torch.meshgrid(torch.arange(h, device=dev), torch.arange(w, device=dev),
                                        indexing="ij")
                grid = torch.stack([(gx + u.clamp(-4, 4)) * (2.0 / (w - 1)) - 1,
                                    (gy + v.clamp(-4, 4)) * (2.0 / (h - 1)) - 1], dim=-1)
                sample = lambda: torch.nn.functional.grid_sample(  # noqa: E731
                    img[:, None], grid, mode="bilinear", padding_mode="border",
                    align_corners=True)
                lib_err = float((sample()[:, 0] - got).abs().max())
                times["full_ms"] = cuda_ms(lambda: k3.window_warp(img, u, v, 4, False))
                times["full_library_ms"] = cuda_ms(sample)
                log(f"[k3] full mode, 400 x 128x128: K3 {times['full_ms']:.4f} ms, "
                    f"F.grid_sample {times['full_library_ms']:.4f} ms (max |diff| "
                    f"{lib_err:.2e}: another weight expression)")
            if (h, w) == (48, 64) and sep:
                # the camera's LK warp: the host cost of one call, and the two
                # pieces the lean launch path dropped (phase 10 prices T2's)
                times["host_us"] = {
                    "call": host_us(lambda: k3.window_warp(img, u, v, 4, True)),
                    "empty_like": host_us(lambda: torch.empty_like(img)),
                    "was_device_context": host_us(lambda: _enter_exit(img.device)),
                    "was_stream_object": host_us(
                        lambda: torch.cuda.current_stream(img.device).cuda_stream)}
                torch.cuda.synchronize()
        body = "vector" if w % 4 == 0 else "scalar"
        log(f"[k3] {n} x {h}x{w} ({body} body), d=4, separable and full: agree with the "
            f"plain version (max abs err {max(errs):.3e})")
    log(f"[k3] 400 x 128x128 separable: K3 {times['ms']:.4f} ms, plain "
        f"{times['plain_ms']:.4f} ms, bound {times['bound_ms']:.4f} ms "
        f"({times['bound_ms'] / times['ms']:.2f} of it; CUDA events, mean of 10)")
    log("[k3] host us per call at 400 x 48x64 (host clock, mean of 2,000): "
        + ", ".join(f"{k} {v:.3f}" for k, v in times["host_us"].items()))
    return {"err": max(errs), **times}


# -- phase 7 ------------------------------------------------------------------

def phase_k2(dev) -> dict:
    """K2 vs its plain version on one batch of key pairs at each production
    level, at the rescue window, and at a wide grid on the tiles route."""
    import dataclasses

    import torch

    from videoquery_torch.kernels import _launch
    from videoquery_torch.kernels import tvl1_level as k2
    from videoquery_torch.kernels.window_warp import window_warp_reference
    from videoquery_torch.pipeline.extract import PRODUCTION_TVL1

    p = PRODUCTION_TVL1
    # (level, height, width, window, pairs)
    cases = [(i, 128 >> i, 128 >> i, max(2, round(6 * 0.5 ** i)), 400) for i in range(4)]
    cases.append((0, 128, 128, 12, 125))             # the rescue window
    cases.append((0, 256, 384, 6, 16))               # a wide grid: the tiles route
    err_max, times, plans = 0.0, {}, {}
    g = torch.Generator(device=dev).manual_seed(7)
    for level, hgt, wid, d, n in cases:
        i0 = smooth_frames(n, hgt, wid, dev, seed=hgt + d)
        # I1: I0 moved by a smooth flow of up to ~d/2 px, plus noise
        sh = torch.full((n, hgt, wid), 0.4 * d, device=dev)
        i1 = window_warp_reference(i0, -sh, 0.5 * sh, d)
        i1 = (i1 + 0.01 * torch.rand(i1.shape, generator=g, device=dev)).contiguous()
        u0 = torch.zeros_like(i0)
        pl = p.at_level(level)
        plan = k2.level_plan(n, hgt, wid, d)
        want_launches = plan.device_launches(k2.warp_mode(pl), pl.n_warps, pl.n_iters)
        u, v = k2.tvl1_level(i0, i1, u0, u0, pl, d)
        ur, vr = k2.tvl1_level_reference(i0, i1, u0, u0, pl, d)
        err = max(float((u - ur).abs().max()), float((v - vr).abs().max()))
        bitwise = bool(torch.equal(u, ur) and torch.equal(v, vr))
        err_max = max(err_max, err)
        if err > FLOW_ATOL_PX or not (torch.isfinite(u).all() and torch.isfinite(v).all()):
            raise AssertionError(f"K2 level {level} ({hgt}x{wid}, d={d}): max |flow "
                                 f"diff| {err:.3e} px beyond {FLOW_ATOL_PX} px")
        launches = _launch.device_launches(lambda: k2.tvl1_level(i0, i1, u0, u0, pl, d))
        if launches != want_launches:
            raise AssertionError(f"K2 {hgt}x{wid} d={d}: {launches} device launches a "
                                 f"call, the plan says {want_launches}")
        ms = cuda_ms(lambda: k2.tvl1_level(i0, i1, u0, u0, pl, d), 5)
        plain = cuda_ms(lambda: k2.tvl1_level_reference(i0, i1, u0, u0, pl, d), 3)
        key = f"{n}x{hgt}x{wid}_d{d}"
        times[key] = (ms, plain)
        plans[key] = {"route": plan.route, "rows": plan.rows, "cluster": plan.cluster,
                      "smem": plan.smem, "device_launches": launches, "bitwise": bitwise}
        parent = PARENT_K2_MS.get(key)
        log(f"[k2] {n} pairs {hgt}x{wid} d={d} ({pl.n_warps} warps x {pl.n_iters} iters): "
            f"route {plan.route}, R {plan.rows}, C {plan.cluster}, {plan.smem} shared bytes, "
            f"{launches} device launches a call; max |flow diff| {err:.3e} px "
            f"(bitwise equal: {bitwise}); K2 {ms:.3f} ms (parent "
            f"{'not measured' if parent is None else f'{parent:.3f} ms'}), plain "
            f"{plain:.3f} ms; mean |u| {float(u.abs().mean()):.3f} px")
    # the other two warp modes (the image's gradients through a separable or
    # a full warp) on the band route: a height below one band, a ragged last
    # band and clusters of 8
    for grad, sep in (("image", True), ("image", False)):
        pm = dataclasses.replace(p.at_level(0), grad_source=grad, separable_warp=sep)
        for n, hgt, wid, d in ((16, 8, 64, 3), (16, 20, 100, 3), (64, 128, 128, 6)):
            i0 = smooth_frames(n, hgt, wid, dev, seed=hgt + wid)
            i1 = (torch.roll(i0, 2, 2) + 0.01 * torch.rand(i0.shape, generator=g, device=dev)
                  ).contiguous()
            u0 = torch.zeros_like(i0)
            u, v = k2.tvl1_level(i0, i1, u0, u0, pm, d)
            ur, vr = k2.tvl1_level_reference(i0, i1, u0, u0, pm, d)
            err = max(float((u - ur).abs().max()), float((v - vr).abs().max()))
            bitwise = bool(torch.equal(u, ur) and torch.equal(v, vr))
            err_max = max(err_max, err)
            if err > FLOW_ATOL_PX:
                raise AssertionError(f"K2 mode {k2.warp_mode(pm)} {hgt}x{wid}: max |flow "
                                     f"diff| {err:.3e} px beyond {FLOW_ATOL_PX} px")
            log(f"[k2] mode {k2.warp_mode(pm)} (grad_source {grad}, separable {sep}), {n} "
                f"pairs {hgt}x{wid} d={d}: route {k2.level_plan(n, hgt, wid, d).route}; max "
                f"|flow diff| {err:.3e} px (bitwise equal: {bitwise})")
    ms, plain = times["400x128x128_d6"]
    # 400 pairs at 128x128 (the padded domain too), 2 warps x 10 iterations:
    # I0, I1, u, v read once, u, v written once; per padded pixel ~50 f32
    # operations per warp (clamps, two 2-tap passes, gradients, rho_c,
    # rgrad) and ~52 per primal-dual iteration (tvl1_level_reference's
    # arithmetic)
    pl = p.at_level(0)
    px = 400 * 128 * 128
    flops = px * pl.n_warps * (50.0 + 52.0 * pl.n_iters)
    return {"err": err_max, "ms": ms, "plain_ms": plain,
            "levels": {k: {"ms": t[0], "plain_ms": t[1], **plans[k]} for k, t in times.items()},
            "plan": plans["400x128x128_d6"],
            **bound(6.0 * px * 4, flops, PEAK_F32)}


# -- phase 8 ------------------------------------------------------------------

def write_synthetic_video(path: str, n_frames: int, seed: int = 0) -> None:
    """340x256 BGR mp4: a textured scene under a camera pan and a slow zoom,
    with a bright square moving across it."""
    import cv2
    import numpy as np

    w, h = 340, 256
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 255, (h * 3, w * 3, 3), np.uint8)
    base = cv2.GaussianBlur(base, (21, 21), 5)
    writer = cv2.VideoWriter(path, cv2.VideoWriter_fourcc(*"mp4v"), 15, (w, h))
    if not writer.isOpened():
        raise IOError("cv2.VideoWriter failed to open (mp4v codec missing?)")
    for i in range(n_frames + 1):            # +1: the decoder skips frame 0
        z = 1.0 + 0.1 * np.sin(i / 40.0)     # zoom
        tx = w + 60 * np.sin(i / 25.0)       # pan, up to ~2.4 px/frame
        ty = h + 1.5 * (i % 150) - 100
        m = np.float32([[z, 0, -tx], [0, z, -ty]])
        frame = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT)
        x0 = int(40 + (i * 4) % (w - 80))
        frame[100:140, x0:x0 + 40] = (240, 240, 250)
        writer.write(np.ascontiguousarray(frame))
    writer.release()


def bf16_criterion(got, want) -> float:
    """The JAX package's bf16-vs-f32 measure (tests/test_nn.py):
    mean |got - want| / mean |want|."""
    import numpy as np

    return float(np.abs(got - want).mean() / (np.abs(want).mean() + 1e-9))


def phase_extract(dev, tmp: str) -> dict:
    """Video -> CSV tree -> broker round on the card (the extraction path)."""
    import numpy as np
    import torch

    from videoquery_torch.index.csvio import read_features_csv
    from videoquery_torch.kernels import inception_block as t1, query as k1, tvl1_flow
    from videoquery_torch.kernels import tvl1_level as k2, window_warp as k3
    from videoquery_torch.nn.bn_inception import BNInception
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.pipeline import decode, extract
    from videoquery_torch.service.loader import DBLoader
    from videoquery_torch.testing.fake_api import FakeAPI, FakeClient

    video = os.path.join(tmp, "synthetic_pan_zoom.mp4")
    out = os.path.join(tmp, "features")
    n_frames = 8 * 150 + 40                        # 8 full clips + a 40-frame tail
    t0 = time.perf_counter()
    write_synthetic_video(video, n_frames)
    log(f"[extract] wrote {n_frames} frames at 340x256 in {time.perf_counter() - t0:.1f} s")

    # the main path: the CLI's code, then the broker round on its CSVs
    k1.LAUNCHES = k2.LAUNCHES = k3.LAUNCHES = 0
    t0 = time.perf_counter()
    extract.main([video, "--out", out, "--seed", "0"])
    t_cli = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as reports:
        states, rounds, api, qid, n_rows = run_fixture_lifecycle(
            dev, exact=False, report_dir=reports, root=out)
    launches = {"K1": k1.LAUNCHES, "K2": k2.LAUNCHES, "K3": k3.LAUNCHES}
    log(f"[extract] CLI: {t_cli:.1f} s for 9 clips incl. decode and the first "
        f"batch's warm-up; loader ingested {n_rows} rows")
    log(f"[extract] broker on the extracted CSVs: states {states}, matches per "
        f"round {[len(r) for r in rounds]}; launches {launches}")
    assert n_rows == 9 * 6, n_rows
    assert states == [4, 4, 7], states
    assert all(rounds), "a round selected no matches"
    assert "min score for a match:" in api.uploaded_reports[qid], "no final report"
    for name, n in launches.items():
        assert n > 0, f"the extraction path never launched {name}"

    # the CLI in bf16 (T1's main path): the loader ingests its CSVs; its
    # signatures meet the JAX package's bf16-vs-f32 criterion against the
    # f32 run's
    out16 = os.path.join(tmp, "features_bf16")
    t1.LAUNCHES = 0
    t0 = time.perf_counter()
    extract.main([video, "--out", out16, "--seed", "0", "--dtype", "bfloat16"])
    t_cli16 = time.perf_counter() - t0
    launches["T1"] = t1.LAUNCHES
    log(f"[extract] CLI --dtype bfloat16: T1 launches {launches['T1']}")
    assert launches["T1"] > 0, "the bf16 extraction path never launched T1"
    n16 = DBLoader(FakeClient(FakeAPI())).load_tree(out16)
    assert n16 == n_rows, (n16, n_rows)
    worst = 0.0
    for root, _dirs, files in os.walk(out):
        for f in files:
            a = read_features_csv(os.path.join(root, f)).features
            b = read_features_csv(os.path.join(out16, os.path.relpath(root, out), f)).features
            worst = max(worst, bf16_criterion(b, a))
    log(f"[extract] CLI --dtype bfloat16: {t_cli16:.1f} s; loader ingested {n16} rows; "
        f"worst CSV mean |bf16 - f32| / mean |f32| {worst:.4f} (< 0.1)")
    assert worst < 0.1, worst

    # timings of one 8-clip batch, and one clip against the CPU
    tsn = TwoStreamTSN.random(0, (1, 2, 3), dev)
    ex = extract.Extractor(tsn, device=dev)
    frames = decode.load_video(video, new_size=ex._decode_size())
    batch = torch.from_numpy(np.stack([frames[i * 150:(i + 1) * 150]
                                       for i in range(8)])).to(dev)
    plan = ex._plan(150)

    def step(dtype="float32"):
        return extract.extract_step(tsn, batch, plan, ex.cfg, True, ex.tvl1, dtype)

    step_ms = p50_ms(step, 3, warmup=1)
    # the bf16 batch with the T1 route and with the unfused route (every
    # block a chain of convs, pools and a concat), in turns
    step16_ms = p50_ms(lambda: step("bfloat16"), 3, warmup=1)
    fused_route = BNInception._inception
    BNInception._inception = BNInception._inception_unfused
    try:
        step16_unfused_ms = p50_ms(lambda: step("bfloat16"), 3, warmup=1)
    finally:
        BNInception._inception = fused_route
    step16_again_ms = p50_ms(lambda: step("bfloat16"), 3, warmup=1)
    t1.LAUNCHES = 0
    step("bfloat16")
    t1_per_batch = t1.LAUNCHES
    log(f"[extract] T1 launches per bf16 8-clip batch: {t1_per_batch} (8 stride-1 blocks x "
        f"3 nets x 2 streams = 48)")
    assert t1_per_batch == 48, t1_per_batch
    sig32, sig16 = step(), step("bfloat16")
    crit16 = max(bf16_criterion(b.cpu().numpy(), a.cpu().numpy())
                 for a, b in zip(sig32, sig16))
    assert all(torch.isfinite(x).all() for x in sig16) and crit16 < 0.1, crit16
    gray, vscale = extract._flow_gray_grid(batch, ex.cfg.flow_res_div)

    def flow(g_):
        return extract._pair_flow(g_, plan.pair_idx, ex.cfg.flow_bound, True, ex.tvl1,
                                  vscale, plan.warm, ex.cfg.flow_warm_camera)

    flow_ms = p50_ms(lambda: flow(gray), 3, warmup=1)
    kernels = (tvl1_flow.tvl1_level, tvl1_flow.window_warp)
    tvl1_flow.tvl1_level, tvl1_flow.window_warp = (k2.tvl1_level_reference,
                                                   k3.window_warp_reference)
    try:
        flow_plain_ms = p50_ms(lambda: flow(gray), 3, warmup=1)
    finally:
        tvl1_flow.tvl1_level, tvl1_flow.window_warp = kernels
    one_card = flow(gray[:1].contiguous()).cpu()
    t0 = time.perf_counter()
    one_cpu = extract._pair_flow(gray[:1].cpu(), plan.pair_idx.cpu(), ex.cfg.flow_bound,
                                 True, ex.tvl1, vscale, tuple(x.cpu() for x in plan.warm),
                                 ex.cfg.flow_warm_camera)
    t_cpu = time.perf_counter() - t0
    diff = (one_card.int() - one_cpu.int()).abs()
    same = float((diff == 0).float().mean())
    log(f"[extract] one clip's {one_card.shape[1]} pairs, card vs CPU plain versions "
        f"({t_cpu:.1f} s on the CPU): {same:.6f} of bytes equal, max diff "
        f"{int(diff.max())} LSB")
    assert same >= 0.999 and int(diff.max()) <= 1, (same, int(diff.max()))
    log(f"[extract] 8-clip batch (1,000 flow pairs, 1,200 BN-Inception forwards): "
        f"p50 {step_ms:.1f} ms ({8e3 / step_ms:.2f} clips/s); its flow: kernels "
        f"p50 {flow_ms:.1f} ms, plain versions p50 {flow_plain_ms:.1f} ms")
    log(f"[extract] the same batch with bf16 networks: p50 {step16_ms:.1f} ms "
        f"({8e3 / step16_ms:.2f} clips/s), again {step16_again_ms:.1f} ms; with the "
        f"unfused route between them {step16_unfused_ms:.1f} ms; signatures mean "
        f"|bf16 - f32| / mean |f32| {crit16:.4f} (< 0.1)")
    # where the time goes: the networks alone (1,200 forwards), f32 and bf16
    rgb_in = torch.randn((200, 224, 224, 3), device=dev) * 50
    nets = {}
    for dtype in ("float32", "bfloat16"):
        x = rgb_in.to(extract.DTYPES[dtype])
        with torch.no_grad():
            tr_net = trace(lambda: tsn.rgb.embed(x))
        log_trace("extract", f"the rgb stream's 3 nets on 200 ticks, {dtype}", tr_net)
        nets[dtype] = {"wall_ms": tr_net["wall_ms"], "busy_ms": tr_net["busy_ms"],
                       "by_kind": by_kind(tr_net)}
    tr = trace(lambda: step("bfloat16"))
    log_trace("extract", "one 8-clip batch with bf16 networks", tr)
    k2_ms, k2_n = kernel_time(tr, k2.DEVICE_KERNELS)
    k3_ms, k3_n = kernel_time(tr, K3_KERNELS)
    t1_ms, t1_n = kernel_time(tr, T1_KERNELS)
    log(f"[extract] in that trace: K2 {k2_ms:.2f} ms of device time in {k2_n} device "
        f"launches, K3 {k3_ms:.2f} ms in {k3_n}, T1 {t1_ms:.2f} ms in {t1_n}")
    return {"launches": launches, "step_ms": step_ms, "flow_ms": flow_ms,
            "flow_plain_ms": flow_plain_ms, "same": same, "step_bf16_ms": step16_ms,
            "step_bf16_again_ms": step16_again_ms, "step_bf16_unfused_ms": step16_unfused_ms,
            "t1_launches_per_bf16_batch": t1_per_batch,
            "bf16_criterion": max(crit16, worst), "rgb_nets_trace": nets,
            "bf16_batch_trace": {"wall_ms": tr["wall_ms"], "busy_ms": tr["busy_ms"],
                                 "idle_share": tr["idle_share"], "k2_ms": k2_ms,
                                 "k2_device_launches": k2_n, "k3_ms": k3_ms,
                                 "k3_device_launches": k3_n, "t1_ms": t1_ms,
                                 "t1_device_launches": t1_n}}


# -- phase 8b -----------------------------------------------------------------

def csv_tree(root: str) -> dict[str, bytes]:
    """{path under root: file bytes} of a CSV tree."""
    out = {}
    for d, _dirs, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return out


def min_cosine(a, b) -> float:
    """The least cosine between matching rows of two [clips, D] arrays."""
    import numpy as np

    return float(((a * b).sum(1) / (np.linalg.norm(a, axis=1) * np.linalg.norm(b, axis=1)
                                    + 1e-12)).min())


def phase_ingest(dev, tmp: str) -> dict:
    """The operator's ingest path in phase 8's directory: two videos through
    the CLI's decode workers with the compact uploads in bf16, held bit for
    bit against one process streaming and that against the whole decoded
    video; the CSVs against phase 8's; the loader's shards onto the card
    against the CSV-built index; K1's top-20 on both."""
    import numpy as np
    import torch

    from videoquery_torch.core.config import ExtractionConfig
    from videoquery_torch.index.csvio import read_features_csv
    from videoquery_torch.index.persist import load_index_binary
    from videoquery_torch.kernels import inception_block as t1, query as k1
    from videoquery_torch.kernels import tvl1_level as k2, window_warp as k3
    from videoquery_torch.nn.tsn import TwoStreamTSN
    from videoquery_torch.pipeline import decode, extract
    from videoquery_torch.pipeline.payload import plan_groups
    from videoquery_torch.service import loader

    videos = [os.path.join(tmp, "synthetic_pan_zoom.mp4"),
              os.path.join(tmp, "synthetic_pan_zoom_b.mp4")]
    write_synthetic_video(videos[1], 4 * 150 + 40, seed=1)      # 4 full clips + a tail
    names = [os.path.splitext(os.path.basename(v))[0] for v in videos]
    flags = ["--host_gray", "--host_crop", "--host_yuv420", "--dtype", "bfloat16"]

    # the main path: the CLI, 2 decode workers, compact uploads, bf16
    out_mp = os.path.join(tmp, "features_compact")
    k2.LAUNCHES = k3.LAUNCHES = t1.LAUNCHES = 0
    t0 = time.perf_counter()
    extract.main([tmp, "--out", out_mp, "--workers", "2", "--seed", "0", *flags])
    t_cli = time.perf_counter() - t0
    launches = {"K2": k2.LAUNCHES, "K3": k3.LAUNCHES, "T1": t1.LAUNCHES}
    log(f"[ingest] CLI {tmp} --workers 2 {' '.join(flags)}: {t_cli:.1f} s with the TSN's "
        f"build and the workers' spawn; launches {launches}")
    for name, n in launches.items():
        assert n > 0, f"the ingest path never launched {name}"

    # one process, the same config and weights: the whole decoded video,
    # then the stream (timed), then the workers again (timed)
    cfg = ExtractionConfig(host_gray=True, host_crop=True, host_yuv420=True)
    ex = extract.Extractor(TwoStreamTSN.random(0, (1, 2, 3), dev), cfg, device=dev,
                           dtype="bfloat16")
    whole, planned = {}, 0
    for v in videos:
        frames = decode.load_video(v, new_size=ex._decode_size())
        planned += sum(len(nums) for _g, nums in plan_groups(len(frames), cfg))
        whole[v] = extract.gather_signatures(list(ex.extract_frames(frames)))
    del frames
    sizes = []
    dispatch = ex._dispatch_payload

    def counted(pl):
        sizes.append((pl.nbytes, len(pl.nums)))
        return dispatch(pl)

    out_stream = os.path.join(tmp, "features_stream")
    ex._dispatch_payload = counted
    t0 = time.perf_counter()
    stream = {v: ex.extract_video_stream(v) for v in videos}
    for v, name in zip(videos, names):
        ex.write_csv_tree(stream[v], out_stream, name, v)
    t_stream = time.perf_counter() - t0
    ex._dispatch_payload = dispatch
    n_clips = sum(len(s.clip_numbers) for sigs in stream.values() for s in sigs)
    out_mp2 = os.path.join(tmp, "features_mp")
    t0 = time.perf_counter()
    by_path = ex.extract_videos(videos, workers=2)
    for v, name in zip(videos, names):
        ex.write_csv_tree(by_path[v], out_mp2, name, v)
    t_mp = time.perf_counter() - t0
    assert n_clips == planned, (n_clips, planned)    # 9 + 5 at the production config

    # where the streaming run's time goes: one traced run over both videos
    tr = trace(lambda: [ex.extract_video_stream(v) for v in videos], warm=False)
    log_trace("ingest", f"one process streaming {n_clips} clips", tr)
    stream_trace = {k: tr[k] for k in ("wall_ms", "busy_ms", "idle_share")}

    # bit for bit: CSV bytes (str of each f32 is exact) and signatures
    got, want = csv_tree(out_mp), csv_tree(out_stream)
    splits = ex.tsn.rgb.splits
    assert sorted(got) == sorted(want) and len(want) == 2 * len(splits) * 2, sorted(got)
    assert got == want, "the 2-worker CLI's CSVs differ from one process streaming"
    assert csv_tree(out_mp2) == want, "extract_videos differs from one process streaming"
    for v in videos:
        assert [s.clip_numbers for s in stream[v]] == [s.clip_numbers for s in whole[v]]
        for a, b in zip(stream[v], whole[v]):
            assert np.array_equal(a.rgb, b.rgb) and np.array_equal(a.flow, b.flow), \
                f"{v}: streaming differs from the whole decoded video"
    log(f"[ingest] the 2-worker CLI's {len(got)} CSVs equal one process streaming byte "
        f"for byte; streaming equals extract_frames over the whole decoded video bit for bit")

    # the compact CSVs against phase 8's full-frame bf16 CSVs of the same video
    cos = {"rgb": 1.0, "warped_optical_flow": 1.0}
    for rel in want:
        if not rel.startswith(names[0] + os.sep):
            continue
        a = read_features_csv(os.path.join(out_mp, rel))
        b = read_features_csv(os.path.join(tmp, "features_bf16", rel))
        assert np.array_equal(a.clip_numbers, b.clip_numbers)
        cos[a.stream] = min(cos[a.stream], min_cosine(a.features, b.features))
    log(f"[ingest] compact against full-frame uploads (phase 8, bf16): least cosine rgb "
        f"{cos['rgb']:.6f} (> 0.999), flow {cos['warped_optical_flow']:.6f} (> 0.97)")
    assert cos["rgb"] > 0.999 and cos["warped_optical_flow"] > 0.97, cos

    # the loader's shards onto the card, against the CSV-built index
    shards = os.path.join(tmp, "shards")
    t0 = time.perf_counter()
    loader.main([out_mp, "--shard_out", shards, "--no_api"])
    t_write = time.perf_counter() - t0
    found, k1_launches = {}, 0
    for dtype in (torch.float32, torch.bfloat16):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = load_index_binary(shards, pad_multiple=32, dtype=dtype, device=dev)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        ref = loader.load_index(out_mp, device=dev, dtype=dtype, pad_multiple=32)
        assert idx.feats.dtype == ref.feats.dtype == dtype and idx.feats.device == dev
        assert torch.equal(idx.feats.view(torch.int16), ref.feats.view(torch.int16)), dtype
        assert torch.equal(idx.mask, ref.mask) and np.array_equal(idx.clip_ids, ref.clip_ids)
        # K1's top-20 on both: 4 targets, each a clip's own features
        pos = torch.tensor([0, 3, 9, 13], device=dev)
        targets = ref.feats[:, :, pos].permute(2, 0, 1, 3).float().contiguous()
        tmask = ref.mask[:, :, pos].permute(2, 0, 1).contiguous()
        weights = torch.tensor([[1.0, 1.5]] * 4, device=dev)
        k1.LAUNCHES = 0
        ids = [k1.fused_query_topk(i.feats, i.mask, targets, tmask, weights, k=20)[1]
               for i in (idx, ref)]
        k1_launches += k1.LAUNCHES
        assert k1.LAUNCHES == 2 and torch.equal(ids[0], ids[1]), dtype
        name = str(dtype).removeprefix("torch.")
        found[name] = {"load_ms": t_load * 1e3, "n_padded": idx.n_padded}
        log(f"[ingest] {idx.n_clips} clips from {len(os.listdir(shards)) - 1} shard(s) onto "
            f"the card in {name}: {t_load * 1e3:.1f} ms, equal to load_index of the CSVs bit "
            f"for bit; K1 top-20 of 4 targets: the same ids on both")

    mb_clip = sum(b for b, _n in sizes) / sum(n for _b, n in sizes) / 1e6
    w, h = ex.cfg.frame_resize
    full_mb_clip = ex.cfg.frames_per_clip * h * w * 3 / 1e6     # the all-frames upload
    result = {"card": card_line(), "clips": n_clips,
              "stream_clips_per_s": n_clips / t_stream, "stream_s": t_stream,
              "workers2_clips_per_s": n_clips / t_mp, "workers2_s": t_mp,
              "cli_workers2_s": t_cli, "stream_trace": stream_trace, "compact_mb_per_clip": mb_clip,
              "full_frame_mb_per_clip": full_mb_clip, "shard_write_ms": t_write * 1e3,
              "shard_load": found, "least_cosine_vs_full_frames": cos,
              "launches": launches, "k1_query_launches": k1_launches}
    log(f"[ingest] file -> CSVs, 2 videos, {n_clips} clips, bf16: one process streaming "
        f"{n_clips / t_stream:.2f} clips/s ({t_stream:.2f} s), 2 decode workers "
        f"{n_clips / t_mp:.2f} clips/s ({t_mp:.2f} s); compact payload {mb_clip:.2f} MB a "
        f"clip (all frames: {full_mb_clip:.1f}); shard write {t_write * 1e3:.1f} ms "
        f"(loader --shard_out --no_api)")
    return result


# -- phase 9 ------------------------------------------------------------------

def phase_t1(dev) -> dict:
    """T1 vs its plain version at the 8 stride-1 shapes (3 members, x
    shared) and in the extraction path's geometry (one member, its own x),
    every bf16 conv outside T1 against f32 rounded once, then the A/B tool
    at 1 x 200 and 3 x 200 bf16 images, T1 held to its plain version there
    too."""
    import torch

    from videoquery_torch.kernels import _launch
    from videoquery_torch.kernels import inception_block as t1
    from videoquery_torch.nn.bn_inception import init_params
    from videoquery_torch.tools import conv_rounding
    from videoquery_torch.tools import inception_block_bench as bench
    from videoquery_torch.tools.inception_block_bench import (BF16_REL, BF16_SHARE,
                                                              bf16_agreement)

    base = init_params(0, 3)
    g = torch.Generator(device=dev).manual_seed(9)
    errs: list[float] = []
    share_min, rel_max = 1.0, 0.0
    dev_launches = set()
    for name in bench.stride1_blocks():
        hw, cin, spec = bench.block_geometry()[name]
        for members, images, dt in ((3, 4, torch.float32), (3, 4, torch.bfloat16),
                                    (1, 25, torch.bfloat16)):
            x, wts = bench.block_case(name, images, members, dt, dev, g, base)
            if members == 1:    # the path's geometry, with non-zero biases
                for b in (wts.b1, wts.b3, wts.bd1, wts.bd2, wts.bpp):
                    b.normal_(0.0, 0.3, generator=g)
            got = t1.fused_inception(wts, name, spec, x)
            want = t1.fused_inception_reference(wts, name, spec, x)
            assert got.shape == want.shape == (members, images, hw, hw, want.shape[-1])
            if dt == torch.float32:
                err = float((got - want).abs().max())
                errs.append(err)
                if not torch.allclose(got, want, rtol=1e-4, atol=1e-5):
                    raise AssertionError(f"T1 {name} f32: max abs err {err:.3e} beyond "
                                         "rtol 1e-4 atol 1e-5")
            else:
                share, rel = bf16_agreement(got, want)
                share_min, rel_max = min(share_min, share), max(rel_max, rel)
                if share < BF16_SHARE or rel > BF16_REL:
                    raise AssertionError(f"T1 {name} bf16 ({members} x {images}): {share:.5f} "
                                         f"of outputs within one ulp, max rel err {rel:.2e}")
                dev_launches.add(_launch.device_launches(
                    lambda: t1.fused_inception(wts, name, spec, x)))
        log(f"[t1] {name} ({hw}x{hw}, cin {cin}): 3 members x 4 images f32 and bf16, and "
            f"1 member x 25 images bf16, agree with the plain version")
    torch.cuda.synchronize()
    log(f"[t1] f32 max abs err {max(errs):.3e} (rtol 1e-4, atol 1e-5); bf16: worst share "
        f"within one ulp {share_min:.5f} (>= {BF16_SHARE}), worst max |diff| / max "
        f"|value| {rel_max:.2e} (<= {BF16_REL:.4f}); device launches a bf16 call "
        f"{sorted(dev_launches)} (profiler)")
    # a trace may miss a launch (kernels/_launch.py), never add one
    assert 0 < max(dev_launches) <= t1.DEVICE_LAUNCHES[torch.bfloat16], dev_launches

    # every bf16 conv outside T1 at the path's shapes: the stem's widened to
    # f32 under TF32 (exact in TF32), the stride-2 blocks' likewise, each
    # against the same conv in f32 rounded once
    rounding = conv_rounding.run(images=200, device=dev, log=lambda m: log(f"[t1] {m}"))
    assert list(rounding) == conv_rounding.convs_outside_t1(), list(rounding)
    low = {k: v for k, v in rounding.items() if v < conv_rounding.BITWISE_SHARE}
    log(f"[t1] the {len(rounding)} bf16 convs outside T1 round once: worst "
        f"{min(rounding.values()):.6f} of outputs bit-equal (>= {conv_rounding.BITWISE_SHARE})")
    assert not low, low

    out = {"err": max(errs), "bf16_share": share_min, "bf16_rel": rel_max,
           "device_launches_bf16": max(dev_launches), "convs_bitwise_share": rounding}
    for splits in (1, 3):
        rows = bench.run(images=200, splits=splits, dtype="bfloat16", reps=10, device=dev,
                         log=lambda m: log(f"[t1] {m}"))
        for r in rows:   # T1 against its plain version at this shape, biases non-zero
            if not r["ok"]:
                raise AssertionError(f"T1 {r['block']} bf16 ({splits} x 200): "
                                     f"{r['share_1ulp']:.5f} of outputs within one ulp, "
                                     f"max rel err {r['rel_err']:.2e}")
        out["bf16_share"] = min(out["bf16_share"], *(r["share_1ulp"] for r in rows))
        out["bf16_rel"] = max(out["bf16_rel"], *(r["rel_err"] for r in rows))
        tot = {k: sum(r[k] for r in rows) for k in ("t1_ms", "cudnn_ms", "plain_ms",
                                                      "bound_ms")}
        out[f"{splits}x200"] = {
            "ms": tot["t1_ms"], "plain_ms": tot["plain_ms"], "library_ms": tot["cudnn_ms"],
            "bound_ms": tot["bound_ms"],
            "blocks": {r["block"]: {k: r[k] for k in ("t1_ms", "cudnn_ms", "plain_ms",
                                                      "bound_ms", "launch_ms",
                                                      "share_1ulp", "rel_err")}
                       for r in rows}}
    return out


# -- phase 10 -----------------------------------------------------------------

def host_us(fn, reps: int = 2000) -> float:
    """Mean host time of fn() in microseconds (no synchronisation: what the
    calling thread spends), after a warm-up."""
    for _ in range(50):
        fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def t2_host_costs(x, shift) -> dict:
    """The host cost of each piece of a T2 call on the card, in us: the
    pieces of the lean launch path (kernels/_launch.py), the rest of the
    wrapper (its checks and Python) as what the whole call leaves, and two
    pieces the path dropped (a torch.cuda.device context, a
    torch.cuda.Stream object)."""
    import torch

    from videoquery_torch.kernels import roll as t2

    idx = x.get_device()
    entry = t2._ENTRY
    fn = entry.load()
    out = torch.empty_like(x)
    stream = torch._C._cuda_getCurrentRawStream(idx)
    ptrs = (x.data_ptr(), shift.data_ptr(), out.data_ptr())
    block = entry.pack(*ptrs, *x.shape, 0, stream)
    empty = entry.pack(*ptrs, 0, *x.shape[1:], 0, stream)  # n = 0: returns before launching
    costs = {
        "roll_call": host_us(lambda: t2.roll(x, shift, 0)),
        "torch_roll_call": host_us(lambda: torch.roll(x, -5, 1)),
        "empty_like": host_us(lambda: torch.empty_like(x)),
        "data_ptrs": host_us(lambda: (x.data_ptr(), shift.data_ptr(), out.data_ptr())),
        "current_device": host_us(torch._C._cuda_getDevice),
        "raw_stream": host_us(lambda: torch._C._cuda_getCurrentRawStream(idx)),
        "pack": host_us(lambda: entry.pack(*ptrs, *x.shape, 0, stream)),
        "ctypes_call": host_us(lambda: fn(empty)),
        "ctypes_call_and_launch": host_us(lambda: fn(block)),
        "was_device_context": host_us(lambda: _enter_exit(x.device)),
        "was_stream_object": host_us(lambda: torch.cuda.current_stream(x.device).cuda_stream),
    }
    torch.cuda.synchronize()
    costs["cuda_launch"] = costs["ctypes_call_and_launch"] - costs["ctypes_call"]
    costs["checks_and_rest"] = costs["roll_call"] - sum(
        costs[k] for k in ("empty_like", "data_ptrs", "current_device", "raw_stream", "pack",
                           "ctypes_call_and_launch"))
    return costs


def _enter_exit(device) -> None:
    import torch

    with torch.cuda.device(device):
        pass


def phase_t2(dev) -> dict:
    """The roll repro tool on the card (the path whose launches count),
    then T2's time on its tile and the host cost of each piece of a call."""
    import torch

    from videoquery_torch.kernels import roll as t2
    from videoquery_torch.tools import roll_repro

    t2.LAUNCHES = 0
    errs = roll_repro.run(dev, log=lambda m: log(f"[t2] {m}"))
    launches = t2.LAUNCHES
    assert launches == 12 and errs == [0.0] * 12, (launches, errs)
    x = torch.rand((1, roll_repro.H, roll_repro.W), device=dev)
    shift = torch.tensor([-5], dtype=torch.int32, device=dev)
    ms = cuda_ms(lambda: t2.roll(x, shift, 0), 100)
    plain = cuda_ms(lambda: t2.roll_reference(x, shift, 0), 100)
    lib = cuda_ms(lambda: torch.roll(x, -5, 1), 100)
    log(f"[t2] 12 cases equal torch.roll; [1, 80, 256] f32, axis 0: T2 {ms:.4f} ms, "
        f"plain (reads the shift on the host) {plain:.4f} ms, torch.roll {lib:.4f} ms "
        f"(CUDA events, mean of 100)")
    costs = t2_host_costs(x, shift)
    log("[t2] host us per call (host clock, mean of 2,000): "
        + ", ".join(f"{k} {v:.3f}" for k, v in costs.items()))
    return {"launches": launches, "err": max(errs), "ms": ms, "plain_ms": plain,
            "library_ms": lib, "host_us": costs,
            **bound(2.0 * x.numel() * 4, 0.0, PEAK_F32)}


# -- phase 11 -----------------------------------------------------------------

# the production row's EPE gate (docs/TUNING.md:265, :285): the JAX package's
# --final --corpus 3 --scale 2 run gave 0.249-0.253
FQ_EPE_MAX = 0.26
FQ_PRODUCTION = {"default": "pallas half-res (production)",
                 "final": "warm g3 init homog+rescue"}
FQ_REFERENCE = {"default": "baseline (xla full-res s5w5i30)",
                "final": "cold homog (quality ref)"}


def keep_kernel_operands(kept: dict) -> callable:
    """Put a recorder in front of K2 and K3 where the flow path calls them
    (the names tvl1_flow and extract import): it calls the kernel's own
    wrapper, which counts and launches as before, and first keeps a copy of
    the operands of the first call at each (kernel, caller, shape, window,
    mode) in `kept` (a few GB on the card for the gate's two runs). Returns
    the function that takes the recorders away."""
    import inspect

    import torch

    from videoquery_torch.kernels import tvl1_flow
    from videoquery_torch.kernels import tvl1_level as k2
    from videoquery_torch.kernels import window_warp as k3
    from videoquery_torch.pipeline import extract

    def recorder(kind, fn):
        sig = inspect.signature(fn)

        def call(*args, **kwargs):
            bound_args = sig.bind(*args, **kwargs)
            bound_args.apply_defaults()
            ops = dict(bound_args.arguments)
            tensors = [t for t in ops.values() if torch.is_tensor(t)]
            key = (kind, sys._getframe(1).f_code.co_qualname, tuple(tensors[0].shape),
                   *(repr(x) for x in ops.values() if not torch.is_tensor(x)))
            if key not in kept:
                kept[key] = {k: x.clone() if torch.is_tensor(x) else x
                             for k, x in ops.items()}
            return fn(*args, **kwargs)
        return call

    names = [(tvl1_flow, "tvl1_level", recorder("K2", k2.tvl1_level)),
             (tvl1_flow, "window_warp", recorder("K3", k3.window_warp)),
             (extract, "window_warp", recorder("K3", k3.window_warp))]
    before = [(mod, name, getattr(mod, name)) for mod, name, _ in names]
    for mod, name, fn in names:
        setattr(mod, name, fn)
    return lambda: [setattr(mod, name, fn) for mod, name, fn in before]


def check_kept_operands(kept: dict) -> dict:
    """K2 and K3 against their plain versions on the operands the gate gave
    them (keep_kernel_operands): K2 within FLOW_ATOL_PX, K3 within RTOL and
    ATOL. These launches come after the gate's counts were read."""
    from videoquery_torch.kernels import tvl1_level as k2
    from videoquery_torch.kernels import window_warp as k3

    out = {"K2": {"err": 0.0, "cases": []}, "K3": {"err": 0.0, "cases": []}}
    for key, ops in kept.items():
        kind, caller, shape = key[:3]
        n, h, w = shape
        if kind == "K2":
            d = ops["max_disp"]
            u, v = k2.tvl1_level(**ops)
            ur, vr = k2.tvl1_level_reference(**ops)
            err = max(float((u - ur).abs().max()), float((v - vr).abs().max()))
            what = (f"{caller}: {n} pairs {h}x{w} d={d} mode {k2.warp_mode(ops['p'])}, "
                    f"{ops['p'].n_warps} warps x {ops['p'].n_iters} iters, route "
                    f"{k2.level_plan(n, h, w, d).route}")
            if not err <= FLOW_ATOL_PX:
                raise AssertionError(f"K2 at the gate's {what}: max |flow diff| {err:.3e} px "
                                     f"beyond {FLOW_ATOL_PX} px")
        else:
            d = ops["d"]
            errs: list[float] = []
            what = f"{caller}: {n} x {h}x{w} d={d} separable={ops['separable']}"
            check_close(f"K3 at the gate's {what}", k3.window_warp(**ops),
                        k3.window_warp_reference(**ops), errs)
            err = errs[0]
        out[kind]["err"] = max(out[kind]["err"], err)
        out[kind]["cases"].append(f"{what}: {err:.3e}")
        log(f"[flow_quality] {kind} against its plain version at {what}: max abs err "
            f"{err:.3e}")
    return out


def phase_flow_quality() -> dict:
    """The flow-quality gate (videoquery_torch.tools.flow_quality) on the
    card: its default table (corpus 4, scale 1, seed 0: the gather baseline
    and three K2/K3 rows), then --final --corpus 3 --scale 2 (seed 0: five
    K2/K3 rows). Each run's K2 and K3 counts are set to 0 just before it
    and read just after; both must launch. Every row's numbers finite; the
    production row of --final within the EPE gate. Then K2 and K3 against
    their plain versions on the operands of their first call at each
    caller, shape and window in those runs (K2's tiles route at 128x176 and
    K3's affine residual among them)."""
    from videoquery_torch.kernels import tvl1_level as k2
    from videoquery_torch.kernels import window_warp as k3
    from videoquery_torch.tools import flow_quality as fq

    runs, kept = {}, {}
    for tag, argv in (("default", ["--seeds", "0"]),
                      ("final", ["--final", "--corpus", "3", "--scale", "2", "--seeds", "0"])):
        log(f"[flow_quality] {tag}: python -m videoquery_torch.tools.flow_quality "
            f"{' '.join(argv)}")
        restore = keep_kernel_operands(kept)
        try:
            k2.LAUNCHES = k3.LAUNCHES = 0
            t0 = time.perf_counter()
            out = fq.run(argv + ["--device", "cuda"])
            seconds = time.perf_counter() - t0
            launches = {"K2": k2.LAUNCHES, "K3": k3.LAUNCHES}
        finally:
            restore()
        if not (launches["K2"] and launches["K3"]):
            raise AssertionError(f"flow quality {tag}: K2 or K3 never launched {launches}")
        for row in out["rows"]:
            nums = [row["retrieval"]] + [row[k] for k in ("epe_mean", "epe_p90", "epe_obj",
                                                          "epe_bg")]
            if not all(x == x and abs(x) < float("inf") for x in nums):
                raise AssertionError(f"flow quality {tag}: {row['name']}: {nums}")
            routes = ", ".join(f"{r['h']}x{r['w']} d={r['d']} {r['route']}"
                               for r in row.get("k2_routes", []))
            log(f"[flow_quality] {tag}: {row['name']}: K2 routes {routes or 'none (gather)'}")
        rows = {r["name"]: r for r in out["rows"]}
        prod, ref = rows[FQ_PRODUCTION[tag]], rows[FQ_REFERENCE[tag]]
        log(f"[flow_quality] {tag}: {seconds:.1f} s (operands kept included), K2 "
            f"{launches['K2']} and K3 {launches['K3']} launches; production EPE "
            f"{prod['epe_mean']:.4f}, retrieval {prod['retrieval']:.3f} against "
            f"{ref['name']}'s {ref['retrieval']:.3f} (EPE {ref['epe_mean']:.4f})")
        if tag == "final" and not prod["epe_mean"] <= FQ_EPE_MAX:
            raise AssertionError(f"flow quality: {prod['name']} EPE {prod['epe_mean']:.4f} "
                                 f"above the gate {FQ_EPE_MAX}")
        runs[tag] = {"seconds": seconds, "launches": launches, "rows": out["rows"],
                     "cosine_vs_baseline": out.get("cosine_vs_baseline")}
    t0 = time.perf_counter()
    checked = check_kept_operands(kept)
    kept.clear()
    # the shapes the gate must have given the kernels
    if not any("route tiles" in c for c in checked["K2"]["cases"]):
        raise AssertionError("flow quality: no K2 call on the tiles route was checked")
    if not any(c.startswith("_affine_warp_rollwindow") for c in checked["K3"]["cases"]):
        raise AssertionError("flow quality: no affine residual warp on K3 was checked")
    log(f"[flow_quality] {len(checked['K2']['cases'])} K2 and {len(checked['K3']['cases'])} "
        f"K3 operand sets agree with the plain versions (K2 max |flow diff| "
        f"{checked['K2']['err']:.3e} px, K3 max abs err {checked['K3']['err']:.3e}), "
        f"{time.perf_counter() - t0:.1f} s")
    runs["checked"] = checked
    return runs


# -- phase 12 -----------------------------------------------------------------

def phase_sharded(dev, mesh, query: dict, n_segments=1_000_000, q=16, k=20,
                  n_shards=4, repeats=10) -> dict:
    """ShardedSearch on the NCCL world of one rank over phase 5b's index
    (same seed): its top-k against fused_query_topk (ids equal, values
    bitwise); the index split into n_shards row shards in this process,
    each shard's K1 top-k merged, against the unsharded top-k; the p50 of
    the sharded call beside K1's; K1's launches on the sharded path."""
    import numpy as np
    import torch

    from videoquery_torch.index.store import FeatureIndex
    from videoquery_torch.kernels import query as k1
    from videoquery_torch.search.distributed import ShardedSearch, merge_topk

    feats, mask, targets, tmask, weights = query_world(dev, n_segments, q)
    index = FeatureIndex(np.arange(n_segments, dtype=np.int64), feats, mask, STREAMS,
                         (1, 2, 3), "global_pool")
    search = ShardedSearch(index, mesh)
    # a world of one rank: its shard is the index itself, no copy
    assert search.index.feats.data_ptr() == feats.data_ptr()
    k1.LAUNCHES = 0
    vals, ids = search.topk(targets, tmask, weights, k)     # the main path
    launches = k1.LAUNCHES
    assert launches >= 1, "the sharded search launched no K1"
    want_vals, want_pos = k1.fused_query_topk(feats, mask, targets, tmask, weights, k=k)
    want_vals, want_pos = want_vals.cpu().numpy(), want_pos.cpu().numpy()
    assert vals.shape == (q, k) and np.isfinite(vals).all()
    assert np.array_equal(ids, want_pos), "sharded top-k ids differ from fused_query_topk's"
    assert np.array_equal(vals.view(np.uint32), want_vals.view(np.uint32)), (
        "sharded top-k values differ from fused_query_topk's")
    log(f"[sharded] ShardedSearch (NCCL, world of 1, impl=pallas), {q} queries x "
        f"{n_segments} bf16 segments, top-{k}: ids equal and values bitwise equal to "
        f"fused_query_topk's; K1 launches {launches}")

    # n_shards row shards in this process: each shard's K1 top-k (the first
    # also against the plain version), then the merge
    errs: list[float] = []
    shard_vals, shard_pos = [], []
    for r in range(n_shards):
        sh = index.shard(r, n_shards, dev)
        v, i = k1.fused_query_topk(sh.feats, sh.mask, targets, tmask, weights, k=k)
        if r == 0:
            v_r, i_r = torch.topk(k1.fused_query_scores_reference(
                sh.feats, sh.mask, targets, tmask, weights), k)
            check_close(f"shard 0 of {n_shards} top-k values", v, v_r, errs)
            assert torch.equal(i, i_r), "shard 0's top-k ids differ from the plain version's"
        shard_vals.append(v)
        shard_pos.append(i + r * sh.n_padded)
        del sh
    mv, mp = merge_topk(torch.stack(shard_vals), torch.stack(shard_pos), k)
    mv, mp = mv.cpu().numpy(), mp.cpu().numpy()
    assert np.array_equal(mp, want_pos), f"the {n_shards}-shard merge's ids differ"
    merge_err = float(np.abs(mv - want_vals).max())
    errs.append(merge_err)
    assert np.allclose(mv, want_vals, rtol=RTOL, atol=ATOL), (
        f"the {n_shards}-shard merge's values differ by {merge_err:.3e}")
    merge_bitwise = bool(np.array_equal(mv.view(np.uint32), want_vals.view(np.uint32)))
    log(f"[sharded] {n_shards} row shards of {n_segments // n_shards}, each K1 + top-{k}, "
        f"merged: ids equal to the unsharded top-{k}, values "
        f"{'bitwise equal' if merge_bitwise else f'within {merge_err:.3e}'}")

    # p50 of the sharded call (K1, top-k, the all-gather, the merge, the
    # [Q, k] download) beside K1 + top-k alone, in turns
    def direct():
        v, i = k1.fused_query_topk(feats, mask, targets, tmask, weights, k=k)
        return v.cpu(), i.cpu()

    sharded_ms = p50_ms(lambda: search.topk(targets, tmask, weights, k), repeats)
    direct_ms = p50_ms(direct, repeats)
    sharded2_ms = p50_ms(lambda: search.topk(targets, tmask, weights, k), repeats)
    direct2_ms = p50_ms(direct, repeats)
    log(f"[sharded] p50 of {repeats}: ShardedSearch.topk {sharded_ms:.3f} / "
        f"{sharded2_ms:.3f} ms, fused_query_topk + download {direct_ms:.3f} / "
        f"{direct2_ms:.3f} ms (phase 5b's K1 + top-k p50 {query['query_ms']:.3f} ms)")
    del feats, mask, index, search
    torch.cuda.empty_cache()
    return {"launches": launches, "ms": sharded_ms, "again_ms": sharded2_ms,
            "direct_ms": direct_ms, "direct_again_ms": direct2_ms,
            "merge_shards": n_shards, "merge_bitwise": merge_bitwise, "err": max(errs)}


# -- phase 13 -----------------------------------------------------------------

TRAIN_RTOL_LOSS = 1e-5                   # tests/test_distributed.py:87-116
TRAIN_RTOL_W, TRAIN_ATOL_W = 2e-4, 2e-6


def phase_train(dev, mesh, tmp: str, videos=32, steps=10, flow_steps=3) -> dict:
    """TSNTrainer under DDP on the NCCL world of one rank: the rgb stream at
    224x224, 101 classes, 3 segments, dropout 0.8, `steps` steps on one
    seeded batch of `videos` videos (the loss must fall); the flow stream
    (10 channels) for `flow_steps`; at 2 videos and dropout 0 the card's
    first step against the CPU's; a checkpoint saved, loaded into a fresh
    trainer and stepped, against continuing."""
    import numpy as np
    import torch

    from videoquery_torch.nn import bn_inception
    from videoquery_torch.train.checkpoint import load_train_state, save_train_state
    from videoquery_torch.train.trainer import TrainConfig, TSNTrainer

    rng = np.random.default_rng(13)
    frames = rng.standard_normal((videos, 3, 224, 224, 3), dtype=np.float32)
    labels = rng.integers(0, bn_inception.NUM_CLASSES, size=(videos,))
    cfg = TrainConfig(num_segments=3, dropout_rate=0.8, learning_rate=0.01)
    out = {"videos": videos, "images_per_step": videos * 3}

    def run(trainer, batch, n, seed0):
        losses, times = [], []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            m = trainer.step(*batch, seed=seed0 + i)       # returns host floats
            times.append((time.perf_counter() - t0) * 1e3)
            losses.append(m["loss"])
        assert np.isfinite(losses).all(), losses
        return losses, times

    torch.cuda.reset_peak_memory_stats(dev)
    rgb = TSNTrainer(bn_inception.init_params(0), cfg, mesh=mesh, device=dev)
    losses, times = run(rgb, (frames, labels), steps, 0)
    assert losses[-1] < losses[0], f"the loss did not fall over {steps} steps: {losses}"
    p50 = statistics.median(times[1:])
    out["rgb"] = {"losses": losses, "step_ms": times, "step_p50_ms": p50,
                  "images_per_s": videos * 3 / (p50 / 1e3),
                  "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"[train] rgb, {videos} videos x 3 segments at 224x224, dropout 0.8, DDP (NCCL, "
        f"world of 1): loss {losses[0]:.4f} -> {losses[-1]:.4f} over {steps} steps; step "
        f"p50 {p50:.1f} ms (first {times[0]:.1f}), {out['rgb']['images_per_s']:.0f} images/s, "
        f"peak {out['rgb']['peak_gb']:.2f} GB allocated")
    # where a step's time goes: its operations (aten's flop counter: the
    # convs and the head, forward and backward) against the f32 peak, and
    # one traced step (device busy time, idle share, top kernels)
    from torch.utils.flop_counter import FlopCounterMode

    with FlopCounterMode(display=False) as fc:
        rgb.step(frames, labels, seed=steps)
    flops = fc.get_total_flops()
    tr = trace(lambda: rgb.step(frames, labels, seed=steps + 1), top=10, warm=False)
    out["rgb"].update(step_tflop=flops / 1e12, tflops_per_s=flops / (p50 / 1e3) / 1e12,
                      f32_bound_ms=flops / PEAK_F32 * 1e3,
                      trace={"wall_ms": tr["wall_ms"], "busy_ms": tr["busy_ms"],
                             "idle_share": tr["idle_share"],
                             "by_kind_ms": {k: ms for k, (ms, _n) in by_kind(tr).items()}})
    log(f"[train] a step: {flops / 1e12:.3f} TFLOP (convs and head, forward and backward), "
        f"{flops / (p50 / 1e3) / 1e12:.1f} TFLOP/s at the p50; f32 bound "
        f"{flops / PEAK_F32 * 1e3:.1f} ms at {PEAK_F32 / 1e12:.0f} TFLOP/s")
    log_trace("train", "one rgb step", tr)
    del rgb
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    flow_frames = rng.standard_normal((videos, 3, 224, 224, bn_inception.FLOW_CHANNELS),
                                      dtype=np.float32)
    flow = TSNTrainer(bn_inception.init_params(1, in_channels=bn_inception.FLOW_CHANNELS),
                      cfg, mesh=mesh, device=dev)
    losses, times = run(flow, (flow_frames, labels), flow_steps, 100)
    out["flow"] = {"losses": losses, "step_ms": times,
                   "step_p50_ms": statistics.median(times[1:]),
                   "peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    log(f"[train] flow (10 channels), {flow_steps} steps: losses "
        f"{', '.join(f'{x:.4f}' for x in losses)}; step p50 {out['flow']['step_p50_ms']:.1f} "
        f"ms, peak {out['flow']['peak_gb']:.2f} GB")
    del flow, flow_frames
    torch.cuda.empty_cache()

    # the card's first step against the CPU's: 2 videos, dropout 0
    cfg0 = TrainConfig(num_segments=3, dropout_rate=0.0, learning_rate=0.01)
    small = (frames[:2], labels[:2])
    params = bn_inception.init_params(2)
    card = TSNTrainer(params, cfg0, mesh=mesh, device=dev)
    host = TSNTrainer(params, cfg0, device="cpu")
    mc, mh = card.step(*small, seed=0), host.step(*small, seed=0)
    loss_rel = abs(mc["loss"] - mh["loss"]) / abs(mh["loss"])
    assert loss_rel <= TRAIN_RTOL_LOSS, (mc, mh)
    pc, ph = card.params(), host.params()
    worst = 0.0                  # the largest |diff| / (atol + rtol |cpu|) of any weight
    for name in ph:
        for leaf in ("w", "b"):
            a, b = pc[name][leaf], ph[name][leaf]
            worst = max(worst, float((np.abs(a - b) / (TRAIN_ATOL_W + TRAIN_RTOL_W * np.abs(b))).max()))
    assert worst <= 1.0, f"weights after one step: card vs CPU at {worst:.2f} of the tolerance"
    out["card_vs_cpu"] = {"loss_card": mc["loss"], "loss_cpu": mh["loss"], "loss_rel": loss_rel,
                          "weights_share_of_tolerance": worst}
    log(f"[train] 2 videos, dropout 0: the card's first step against the CPU's: loss "
        f"{mc['loss']:.6f} / {mh['loss']:.6f} (rel {loss_rel:.2e}, rtol {TRAIN_RTOL_LOSS}); "
        f"every weight within {worst:.3f} of rtol {TRAIN_RTOL_W} / atol {TRAIN_ATOL_W}")
    del host

    # a checkpoint on the card: save after step 1, load into a fresh trainer,
    # take step 2 on both
    path = save_train_state(os.path.join(tmp, "train_ckpt"), card.params(), card.opt_state(),
                            card.steps)
    state = load_train_state(path)
    resumed = TSNTrainer(state["params"], cfg0, mesh=mesh, device=dev,
                         opt_state=state["opt_state"], step=state["step"])
    ma, mb = card.step(*small, seed=1), resumed.step(*small, seed=1)
    assert ma == mb, (ma, mb)
    pa, pb = card.params(), resumed.params()
    assert all(np.array_equal(pa[n][leaf], pb[n][leaf]) for n in pa for leaf in ("w", "b")), (
        "resuming from the checkpoint differs from continuing")
    out["checkpoint"] = {"bytes": os.path.getsize(path), "resume_equals_continuing": True}
    log(f"[train] checkpoint ({os.path.getsize(path) / 1e6:.1f} MB npz) saved after step 1, "
        f"loaded into a fresh trainer: its step 2 equals continuing, bit for bit")
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this smoke run needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "videoquery_torch")):
        print(f"chip_smoke: no videoquery_torch package beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda:0")

    card = card_line()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    import torch.distributed as dist

    from videoquery_torch.core.meshes import initialize_multihost, make_mesh
    from videoquery_torch.kernels import _build, inception_block as t1, query as k1
    from videoquery_torch.kernels import roll as t2, tvl1_level as k2, window_warp as k3

    sources = ("query_kernel.cu", "tvl1_level.cu", "window_warp.cu", "inception_block.cu",
               "roll.cu")
    t0 = time.perf_counter()
    _build.build(sources)
    k1._ENTRY.load(), k2._ENTRY.load(), k3._ENTRY.load(), t1._ENTRY.load(), t2._ENTRY.load()
    log(f"[build] K1, K2, K3, T1, T2 ready in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {' '.join(_build.NVCC_FLAGS)}, one process per source)")
    for src in sources:
        for line in ptxas_summary(_build.BUILD_LOG.get(src, "")):
            log(f"[build] {src}: {line}")

    cuda_tests = phase_cuda_tests()
    max_err = phase_k1(dev)
    launches = phase_broker(dev)
    rounds = phase_rounds(dev)
    query = phase_query(dev)
    warp = phase_k3(dev)
    level = phase_k2(dev)
    with tempfile.TemporaryDirectory() as tmp:
        ext = phase_extract(dev, tmp)
        ingest = phase_ingest(dev, tmp)
    block = phase_t1(dev)
    rollp = phase_t2(dev)
    quality = phase_flow_quality()
    with tempfile.TemporaryDirectory() as tmp:
        # a NCCL world of one rank on this card for phases 12-13
        initialize_multihost(f"file://{os.path.join(tmp, 'store')}", 1, 0, dev)
        try:
            mesh = make_mesh("cuda")
            sharded = phase_sharded(dev, mesh, query)
            train = phase_train(dev, mesh, tmp)
        finally:
            dist.destroy_process_group()

    print(json.dumps({"ingest": ingest}))
    print(json.dumps({"flow_quality": quality}))
    print(json.dumps({"scale_out": sharded, "train": train}))
    log(card_line())  # the card and its power limit, as nvidia-smi prints them
    print(json.dumps({"kernels": [{
        "name": "K1 fused query scoring (avg+counts and scores epilogues)",
        "route": "cuda", "source": K1_SOURCE, "replaces": K1_REPLACES,
        "launches": launches,
        "max_abs_err": max(max_err, rounds["err"], query["err"], sharded["err"]),
        "ms": query["query_ms"], "plain_ms": query["query_plain_ms"],
        "bound_ms": query["bound_ms"], "bound_by": query["bound_by"],
        "library_ms": query["library_ms"],
        "library_call": "torch.matmul of the same bf16 products (no mask, score or top-k)",
        "shape": "16 queries x 1M segments bf16, top-20",
        "round_ms_100k_q8": rounds["round_ms"],
        "avg_counts_ms_100k_q8": rounds["sim_ms"],
        "avg_counts_plain_ms_100k_q8": rounds["sim_plain_ms"],
        "scores_pass_events_ms": query["scores_ms"], "topk_events_ms": query["topk_ms"],
        "library_events_ms": query["library_events_ms"],
        "avg_counts_ms_1m_bf16_q8": query["avg_counts_ms_1m_bf16_q8"],
        "avg_counts_bound_ms_1m_bf16_q8": query["avg_counts_bound_ms_1m_bf16_q8"],
        "launches_extract_path": ext["launches"]["K1"],
        "launches_ingest_query": ingest["k1_query_launches"],
        "launches_sharded_path": sharded["launches"],
        "sharded_topk_ms": sharded["ms"], "sharded_topk_again_ms": sharded["again_ms"],
        "sharded_direct_ms": sharded["direct_ms"],
        "sharded_direct_again_ms": sharded["direct_again_ms"],
        "max_abs_err_sharded": sharded["err"],
    }, {
        "name": "K2 TV-L1 pyramid level (clamp, window warp, linearise, primal-dual)",
        "route": "cuda", "source": K2_SOURCE, "replaces": K2_REPLACES,
        "launches": ext["launches"]["K2"],
        "max_abs_err": max(level["err"], quality["checked"]["K2"]["err"]),
        "ms": level["ms"], "plain_ms": level["plain_ms"],
        "bound_ms": level["bound_ms"], "bound_by": level["bound_by"], "library_ms": None,
        "shape": "400 pairs 128x128, d=6, 2 warps x 10 iters, warped+separable",
        "plan": level["plan"], "levels": level["levels"],
        "batch_flow_ms": ext["flow_ms"], "batch_flow_plain_ms": ext["flow_plain_ms"],
        "batch_ms": ext["step_ms"], "clip_bytes_equal_cpu": ext["same"],
        "bf16_batch_trace": ext["bf16_batch_trace"],
        "launches_ingest_path": ingest["launches"]["K2"],
        "launches_flow_quality_default": quality["default"]["launches"]["K2"],
        "launches_flow_quality_final": quality["final"]["launches"]["K2"],
        "max_abs_err_flow_quality": quality["checked"]["K2"]["err"],
        "flow_quality_checked": quality["checked"]["K2"]["cases"],
    }, {
        "name": "K3 window warp (separable and full)",
        "route": "cuda", "source": K3_SOURCE, "replaces": K3_REPLACES,
        "launches": ext["launches"]["K3"],
        "max_abs_err": max(warp["err"], quality["checked"]["K3"]["err"]),
        "ms": warp["ms"], "plain_ms": warp["plain_ms"],
        "bound_ms": warp["bound_ms"], "bound_by": warp["bound_by"], "library_ms": None,
        "shape": "400 x 128x128, d=4, separable",
        "full_mode_ms": warp["full_ms"], "full_mode_library_ms": warp["full_library_ms"],
        "full_mode_library_call": "F.grid_sample, bilinear, border padding",
        "host_us_48x64": warp["host_us"],
        "launches_ingest_path": ingest["launches"]["K3"],
        "launches_flow_quality_default": quality["default"]["launches"]["K3"],
        "launches_flow_quality_final": quality["final"]["launches"]["K3"],
        "max_abs_err_flow_quality": quality["checked"]["K3"]["err"],
        "flow_quality_checked": quality["checked"]["K3"]["cases"],
    }, {
        "name": "T1 fused stride-1 Inception block (bf16: an x-tile and two 3x3 wgmma "
                "implicit-GEMM launches per call)",
        "route": "cuda", "source": T1_SOURCE, "replaces": T1_REPLACES,
        "launches": ext["launches"]["T1"], "max_abs_err": block["err"],
        "ms": block["1x200"]["ms"], "plain_ms": block["1x200"]["plain_ms"],
        "bound_ms": block["1x200"]["bound_ms"], "bound_by": "operations",
        "library_ms": block["1x200"]["library_ms"],
        "library_call": "the same block as a bare chain of cuDNN bf16 calls (conv with "
                        "bias, ReLU, pool, concat), channels-last",
        "shape": "the 8 stride-1 blocks, 1 member x 200 images bf16 (the extraction "
                 "path's call), summed",
        "blocks_ms": block["1x200"]["blocks"],
        "table_shape": dict(shape="the 8 stride-1 blocks, 3 members x 200 images bf16, "
                                  "x shared, summed",
                            **{k: v for k, v in block["3x200"].items() if k != "blocks"}),
        "table_blocks_ms": block["3x200"]["blocks"],
        "device_launches_per_call_profiled": block["device_launches_bf16"],
        "launches_per_bf16_batch": ext["t1_launches_per_bf16_batch"],
        "bf16_share_within_1ulp": block["bf16_share"], "bf16_max_rel_err": block["bf16_rel"],
        "convs_outside_t1_bitwise_share": block["convs_bitwise_share"],
        "extract_batch_bf16_ms": ext["step_bf16_ms"],
        "extract_batch_bf16_again_ms": ext["step_bf16_again_ms"],
        "extract_batch_bf16_unfused_ms": ext["step_bf16_unfused_ms"],
        "extract_bf16_criterion": ext["bf16_criterion"],
        "rgb_nets_trace": ext["rgb_nets_trace"],
        "cuda_tests_passed": cuda_tests,
        "launches_ingest_path": ingest["launches"]["T1"],
    }, {
        "name": "T2 roll by a shift read from device memory",
        "route": "cuda", "source": T2_SOURCE, "replaces": T2_REPLACES,
        "launches": rollp["launches"], "max_abs_err": rollp["err"],
        "ms": rollp["ms"], "plain_ms": rollp["plain_ms"],
        "bound_ms": rollp["bound_ms"], "bound_by": rollp["bound_by"],
        "library_ms": rollp["library_ms"], "library_call": "torch.roll with a host shift",
        "shape": "[1, 80, 256] f32, axis 0, shift -5",
        "host_us": rollp["host_us"],
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
