"""The extractor's dispatch on the port: the rescue decided without a host
wait in between, one pinned upload a batch, and the four functions that
had no twin (kernels.motion.estimate_affine and lk_affine,
search.optimizer.grid_losses, ClipSignatures.materialize).

On the CPU the kernels' plain versions run. Tolerances:
- extract_step against embed_step(prepare_step(...)), the rescue decided at
  once: bit for bit (the same operations on the same inputs, queued in
  another order);
- the rescue sharded over 2 Gloo ranks (two threads of this process)
  against the unsharded rescue: bit for bit;
- a ``_dispatch_payload`` batch against the step on the same arrays: bit
  for bit;
- estimate_affine and lk_affine against the JAX functions: rtol 1e-4 /
  atol 1e-5 (tests/test_torch_gather_tvl1.py's for lk_affine_batch);
- grid_losses against JAX: rtol 1e-5 / atol 1e-6 (f32 sums in another
  order);
- materialize: exact.
"""

import dataclasses
import datetime
import threading

import cv2
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from videoquery.kernels import motion as jm
from videoquery.search import optimizer as jo
from videoquery_torch.core.config import ExtractionConfig
from videoquery_torch.core.transfer import put_tree
from videoquery_torch.kernels import motion as tm
from videoquery_torch.nn.tsn import TwoStreamTSN
from videoquery_torch.pipeline import extract as te
from videoquery_torch.pipeline.payload import build_payload, plan_groups
from videoquery_torch.search import optimizer as to
from videoquery_torch.testing import multihost_worker as mw

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

# 2 clips of 10 frames a batch at 64x80 (flow grid 32x40), 3 ticks
CFG = dict(fps=5, clip_seconds=2, num_ticks=3, frame_resize=(80, 64), crop_size=64,
           batch_clips=2, min_tail_seconds=1)
# the extraction world's schedule with the rescue's trigger at 0.3 of the
# window: its moving batch then fires the rescue with a warm plan too
TVL1 = dataclasses.replace(mw.extract_world_tvl1(), rescue_trigger=0.3)


def bits_equal(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.fixture(scope="module")
def tsn():
    return TwoStreamTSN.random(0, (1,), "cpu")


def batch(kind: str) -> torch.Tensor:
    """u8 [2, 10, 64, 80, 3]: "moving" is the extraction world's video (a
    square crossing at 12 px a frame: the rescue fires), "still" holds one
    frame a clip (no motion: it does not)."""
    video = mw.extract_world_video(n_frames=20)
    if kind == "still":
        video = np.repeat(video[[0, 10]], 10, axis=0)
    return torch.from_numpy(video.reshape(2, 10, 64, 80, 3).copy())


@pytest.fixture
def fired(monkeypatch):
    """Whether each rescue decided on fired, in call order, and the wide
    solves (the rescue's, at twice the window) run."""
    seen = {"fired": [], "wide": 0}
    resolve, solve = te._Rescue.resolve, te.tvl1_warped_flow

    def spy(self):
        seen["fired"].append(bool(self.host[0]))
        return resolve(self)

    def counted(i0, i1, p, max_disp=6):
        seen["wide"] += max_disp != 6
        return solve(i0, i1, p, max_disp=max_disp)

    monkeypatch.setattr(te._Rescue, "resolve", spy)
    monkeypatch.setattr(te, "tvl1_warped_flow", counted)
    return seen


@pytest.mark.parametrize("plan", ["warm", "cold"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["moving", "still"])
def test_extract_step_equals_the_decision_made_at_once(tsn, fired, kind, dtype, plan):
    """extract_step (the rescue's choice queued, the rgb stream's networks,
    then the choice read back and the flow stream) gives
    embed_step(prepare_step(...)) bit for bit, with and without pairs to
    re-solve, in f32 and bf16, with a warm and a cold flow plan; a batch
    whose rescue does not fire re-solves nothing."""
    cfg = ExtractionConfig(**CFG, flow_warm_group=3 if plan == "warm" else 1)
    step_plan = te.step_plan(10, cfg, "pallas", "cpu")
    assert (step_plan.warm is not None) == (plan == "warm")
    frames = batch(kind)
    want = te.embed_step(tsn, *te.prepare_step(frames, step_plan, cfg, True, TVL1, dtype))
    got = te.extract_step(tsn, frames, step_plan, cfg, True, TVL1, dtype)
    # the re-solve runs only where the rescue fired, once a step
    assert fired == {"fired": [kind == "moving"] * 2, "wide": 2 * (kind == "moving")}
    for g, w in zip(got, want):
        assert g.shape == (1, 2, 1024) and bool(torch.isfinite(g).all())
        assert bits_equal(g, w)


def test_the_rescue_on_two_gloo_ranks_equals_the_unsharded_one():
    """Each of 2 ranks holds one clip's pairs; the choice is the whole
    batch's (the peaks all-gathered over Gloo), each rank re-solves only its
    own chosen pairs, read from the host's copy of the choice, and the
    ranks' flow together equals the unsharded rescue bit for bit. The
    chosen triggered pairs lie on both ranks."""
    frames = batch("moving")
    gray, _ = te._flow_gray_grid(frames, 2)
    pair_idx = torch.arange(4)
    i0, i1, u, v = te._solve_pairs(gray, pair_idx, True, TVL1)      # [8, 32, 40]
    # saturate two pairs of each clip; every other pair stays below the trigger
    u, v = u.clamp(-1, 1), v.clamp(-1, 1)
    for pair, value in ((1, 6.0), (2, 5.5), (5, 5.8), (6, -5.6)):
        u[pair] = value
    p = dataclasses.replace(TVL1, rescue_frac=0.5, rescue_trigger=0.9)  # k = 4 of 8
    want = te._rescue_fast_motion(i0, i1, u, v, True, p)
    changed = [i for i in range(8) if not torch.equal(want[0][i], u[i])]
    assert changed == [1, 2, 5, 6], changed

    store = dist.HashStore()
    got, errors = {}, []

    def rank(r):
        try:
            pg = dist.ProcessGroupGloo(dist.PrefixStore("rescue", store), r, 2,
                                       datetime.timedelta(seconds=60))
            shard = te.DataShard.of(pg, r, 2, 2)
            rows = slice(4 * r, 4 * r + 4)
            pending = te._rescue_fast_motion(i0[rows], i1[rows], u[rows], v[rows], True, p,
                                             shard=shard, wait=False)
            got[r] = pending.resolve()
        except Exception as exc:  # noqa: BLE001 — re-raised by the test below
            errors.append(exc)

    threads = [threading.Thread(target=rank, args=(r,), daemon=True) for r in range(2)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(120)
    assert not errors and sorted(got) == [0, 1], (errors, sorted(got))
    for i in range(2):
        assert bits_equal(torch.cat([got[0][i], got[1][i]]), want[i])


def test_put_tree_packs_both_payloads_into_one_buffer():
    """The two uint8 payloads come back equal to the arrays, as views of one
    buffer (one copy up), and the arrays may be overwritten at once."""
    rng = np.random.default_rng(0)
    clip_rgb = rng.integers(0, 255, (2, 3, 64, 64, 3), np.uint8)
    gray = rng.integers(0, 255, (2, 10, 32, 40), np.uint8)
    keep = clip_rgb.copy(), gray.copy()
    frames_dev, gray_dev = put_tree((clip_rgb, gray), "cpu")
    clip_rgb[:] = 0
    gray[:] = 0
    assert frames_dev.dtype == gray_dev.dtype == torch.uint8
    assert np.array_equal(frames_dev.numpy(), keep[0])
    assert np.array_equal(gray_dev.numpy(), keep[1])
    assert frames_dev.untyped_storage().data_ptr() == gray_dev.untyped_storage().data_ptr()


@pytest.mark.parametrize("host_gray", [False, True])
def test_a_dispatched_batch_is_unchanged(tsn, host_gray):
    """_dispatch_payload (put_tree's upload, then extract_step) equals the
    step on the payload's own arrays, the decision made at once, bit for
    bit: the full-frame upload and the compact one (the host's gray and
    cropped tick frames)."""
    cfg = ExtractionConfig(**CFG, host_gray=host_gray, host_crop=host_gray)
    video = mw.extract_world_video(n_frames=20)
    group, nums = plan_groups(len(video), cfg)[0]
    payload = build_payload(video, None, group, nums, cfg, cfg.flow_res_div)
    assert (payload.gray is not None) == host_gray
    ex = te.Extractor(tsn, cfg, tvl1=TVL1, device="cpu")
    gray = None if payload.gray is None else torch.from_numpy(payload.gray)
    want = te.embed_step(tsn, *te.prepare_step(
        torch.from_numpy(payload.clip_rgb), ex._plan(payload.f_len), cfg, True, TVL1,
        gray_u8=gray, native_hw=payload.native_hw))
    got = ex._dispatch_payload(payload)
    assert got.clip_numbers == nums == [1, 2]
    assert bits_equal(got.rgb, want[0]) and bits_equal(got.flow, want[1])


def test_estimate_affine_matches_jax():
    """A zoom and a pan with a foreground blob (the IRLS's outliers)."""
    rng = np.random.default_rng(3)
    h, w = 48, 64
    ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)
    u = (0.03 * (xs - w / 2) + 2.0 + 0.05 * rng.standard_normal((h, w))).astype(np.float32)
    v = (0.03 * (ys - h / 2) - 1.0 + 0.05 * rng.standard_normal((h, w))).astype(np.float32)
    u[10:25, 20:40] = -7.0
    v[10:25, 20:40] = 5.0
    want = np.asarray(jm.estimate_affine(jnp.asarray(u), jnp.asarray(v)))
    got = tm.estimate_affine(torch.from_numpy(u), torch.from_numpy(v))
    assert got.shape == (2, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(want[0, 0], 0.03, atol=0.005)    # it found the zoom


@pytest.mark.parametrize("warp", ["default", "given"])
def test_lk_affine_matches_jax(warp):
    """One pair under a small zoom and a pan, with the default bilinear warp
    and with a warp the caller passes (the same sample, written out)."""
    from videoquery.kernels.warp import bilinear_sample as jsample
    from videoquery_torch.kernels.warp import bilinear_sample as tsample

    rng = np.random.default_rng(4)
    h, w = 40, 56
    base = cv2.GaussianBlur(rng.random((h, w)).astype(np.float32), (7, 7), 1.5)
    m = np.float32([[1.02, 0, -0.8], [0, 1.02, 0.6]])
    c1 = cv2.warpAffine(base, m, (w, h), borderMode=cv2.BORDER_REFLECT).astype(np.float32)
    jwarp = twarp = None
    if warp == "given":
        ys, xs = np.mgrid[0:h, 0:w].astype(np.float32)

        def jwarp(img, u_, v_):
            return jsample(img, jnp.asarray(ys) + v_, jnp.asarray(xs) + u_)

        def twarp(img, u_, v_):
            return tsample(img[None], torch.from_numpy(ys) + v_, torch.from_numpy(xs) + u_)[0]

    want = np.asarray(jm.lk_affine(jnp.asarray(base), jnp.asarray(c1), jwarp))
    got = tm.lk_affine(torch.from_numpy(base), torch.from_numpy(c1), twarp)
    assert got.shape == (2, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-5)
    assert abs(want[0, 0] - 0.02) < 0.01                          # it found the zoom


@pytest.mark.parametrize("m,valid", [(37, 37), (64, 37)])
def test_grid_losses_matches_jax(m, valid):
    """The [W, T] loss surface on the optimizer's grids, with and without
    padded reviewed entries."""
    from videoquery_torch.core.config import HyperParams

    hp = HyperParams()
    rng = np.random.default_rng(5)
    sims = rng.uniform(-0.2, 1.0, (2, m)).astype(np.float32)
    labels = rng.integers(0, 2, m).astype(np.float32)
    mask = (np.arange(m) < valid).astype(np.float32)
    wg = np.asarray(hp.weight_grid, np.float32)
    tg = np.asarray(hp.threshold_grid, np.float32)
    want = np.asarray(jo.grid_losses(jnp.asarray(sims), jnp.asarray(labels), jnp.asarray(wg),
                                     jnp.asarray(tg), jnp.float32(0.2), jnp.asarray(mask)))
    got = to.grid_losses(*(torch.from_numpy(a) for a in (sims, labels, wg, tg)),
                         torch.tensor(0.2), torch.from_numpy(mask))
    assert got.shape == (len(wg), len(tg)) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_materialize_downloads_exactly():
    """Device (here CPU) tensors and host arrays alike come back as f32
    numpy arrays with the same values; the clip numbers and splits stay."""
    from videoquery.pipeline.extract import ClipSignatures as JaxSignatures

    rng = np.random.default_rng(6)
    rgb = rng.standard_normal((3, 2, 1024)).astype(np.float32)
    flow = rng.standard_normal((3, 2, 1024)).astype(np.float32)
    sig = te.ClipSignatures([4, 5], torch.from_numpy(rgb), torch.from_numpy(flow), (1, 2, 3))
    want = JaxSignatures([4, 5], jnp.asarray(rgb), jnp.asarray(flow), (1, 2, 3)).materialize()
    for s in (sig.materialize(), sig.materialize().materialize()):
        assert s.clip_numbers == want.clip_numbers and s.splits == want.splits
        for a, b in ((s.rgb, want.rgb), (s.flow, want.flow)):
            assert isinstance(a, np.ndarray) and a.dtype == np.float32
            assert np.array_equal(a, b)
