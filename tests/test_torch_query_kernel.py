"""K1 (videoquery_torch.kernels.query) against the JAX package.

On the CPU the wrappers run K1's plain PyTorch version; it is held here
against the Pallas kernel run in interpret mode (as tests/test_pallas.py
runs it) and against the JAX engine's batched similarity, on the same
inputs made with numpy. Tolerance rtol 1e-5 / atol 1e-6 (tests/test_pallas.py:
the products are exact, only the order of the sums differs); counts and
top-k ids are equal exactly. The CUDA kernel itself is held against the
plain version by the `cuda` test in tests/test_torch_cuda_kernels.py and by
chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from videoquery.kernels.query_pallas import fused_query_scores as jax_scores
from videoquery.kernels.query_pallas import fused_query_topk as jax_topk
from videoquery.search.scoring import (
    ensemble_similarities_batched as jax_batched,
)
from videoquery_torch.kernels import query as k1
from videoquery_torch.search.scoring import (
    ensemble_similarities_batched as port_batched,
)

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

S, K, N, D, Q = 2, 3, 256, 128, 4
RTOL, ATOL = 1e-5, 1e-6
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def make_inputs(seed=0, q=Q):
    rng = np.random.default_rng(seed)
    return dict(
        feats=rng.normal(size=(S, K, N, D)).astype(np.float32),
        mask=rng.random((S, K, N)) > 0.25,
        targets=(rng.normal(size=(q, S, K, D)) * 0.05).astype(np.float32),
        tmask=rng.random((q, S, K)) > 0.1,
        weights=np.tile(np.asarray([1.0, 1.5], np.float32), (q, 1)),
    )


def as_jax(x, jdt):
    return (jnp.asarray(x["feats"], jdt), jnp.asarray(x["mask"]),
            jnp.asarray(x["targets"]), jnp.asarray(x["tmask"]),
            jnp.asarray(x["weights"]))


def as_torch(x, tdt):
    # f32 -> bf16 rounds to nearest even in both frameworks: same bits
    return (torch.from_numpy(x["feats"]).to(tdt), torch.from_numpy(x["mask"]),
            torch.from_numpy(x["targets"]), torch.from_numpy(x["tmask"]),
            torch.from_numpy(x["weights"]))


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_scores_match_pallas_kernel(dtype):
    jdt, tdt = DTYPES[dtype]
    x = make_inputs()
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_scores(*as_jax(x, jdt), tile=128))
    got = k1.fused_query_scores(*as_torch(x, tdt)).numpy()
    finite = want > -1e29
    assert finite.any() and not finite.all()
    np.testing.assert_array_equal(got > -1e29, finite)
    np.testing.assert_allclose(got[finite], want[finite], rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got[~finite], want[~finite])


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_topk_matches_pallas_kernel(dtype):
    jdt, tdt = DTYPES[dtype]
    x = make_inputs(seed=1)
    with pltpu.force_tpu_interpret_mode():
        v_want, i_want = jax_topk(*as_jax(x, jdt), k=10, tile=128)
    v_got, i_got = k1.fused_query_topk(*as_torch(x, tdt), k=10)
    np.testing.assert_array_equal(i_got.numpy(), np.asarray(i_want))
    np.testing.assert_allclose(v_got.numpy(), np.asarray(v_want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_avg_counts_match_jax_engine_similarity(dtype):
    """The engine's epilogue keeps f32 targets against a bf16 index, as the
    JAX einsum promotes them (scoring.py:84-88)."""
    jdt, tdt = DTYPES[dtype]
    x = make_inputs(seed=2)
    f, m, t, tm, _ = as_jax(x, jdt)
    avg_want, cnt_want = jax_batched(t, tm, f, m)
    f, m, t, tm, _ = as_torch(x, tdt)
    avg_got, cnt_got = port_batched(t, tm, f, m)
    np.testing.assert_array_equal(cnt_got.numpy(), np.asarray(cnt_want))
    np.testing.assert_allclose(avg_got.numpy(), np.asarray(avg_want),
                               rtol=RTOL, atol=ATOL)


def test_target_dtype_split_on_bf16_index():
    """Rounding the targets to bf16 (the scores path) is not the engine's
    f32-target product: on a bf16 index the two really differ."""
    x = make_inputs(seed=3)
    f, m, t, tm, _ = as_torch(x, torch.bfloat16)
    a32, c32 = k1.query_k1(f, m, t, tm, target_dtype=torch.float32)
    a16, c16 = k1.query_k1(f, m, t, tm, target_dtype=torch.bfloat16)
    assert torch.equal(c32, c16)
    assert not torch.equal(a32, a16)
    t16 = t.to(torch.bfloat16).float()
    assert torch.equal(a16, k1.query_k1(f, m, t16, tm, target_dtype=torch.float32)[0])


@pytest.mark.parametrize("qb", [1, 2, 3, 8])
@pytest.mark.parametrize("epilogue", ["avg_counts", "scores"])
def test_query_independent_bits(qb, epilogue):
    """Query 0 gives the same bits alone and inside a batch of qb queries
    (the broker's batched == solo contract)."""
    x = make_inputs(seed=4, q=8)
    f, m, t, tm, w = as_torch(x, torch.float32)
    if epilogue == "scores":
        alone = k1.fused_query_scores(f, m, t[:1], tm[:1], w[:1])[0]
        batch = k1.fused_query_scores(f, m, t[:qb], tm[:qb], w[:qb])[0]
        assert torch.equal(alone, batch)
    else:
        a1, c1 = port_batched(t[:1], tm[:1], f, m)
        ab, cb = port_batched(t[:qb], tm[:qb], f, m)
        assert torch.equal(a1[0], ab[0]) and torch.equal(c1[0], cb[0])


def split_values(case):
    """f32 targets for the 3 x bf16 split: its exact range is |t| >= 2**-110
    and zero (see split_targets_bf16)."""
    rng = np.random.default_rng(11)
    n = 4096
    sign = rng.choice([-1.0, 1.0], n)
    if case == "wide_exponents":
        v = sign * rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-110, 128, n)
    elif case == "normal":
        v = rng.normal(size=n) * 0.03                  # the scale of real targets
    elif case == "negative":
        v = -rng.uniform(1.0, 2.0, n) * 2.0 ** rng.integers(-60, 60, n)
    elif case == "zero":
        v = np.zeros(n)
    elif case == "bf16_exact":
        v = torch.from_numpy(rng.normal(size=n)).to(torch.bfloat16).double().numpy()
    else:  # near_max: f32 values within two bf16 ulps of the f32 maximum, each
        # sign; rounding the top quarter of them to bf16 overflows
        top = (np.finfo(np.float32).max.view(np.int32) - 64 * np.arange(n // 2)
               ).astype(np.int32)
        v = np.tile(top.view(np.float32), 2) * np.repeat([1.0, -1.0], n // 2)
    return torch.from_numpy(np.asarray(v, np.float32))


@pytest.mark.parametrize("case", ["wide_exponents", "normal", "negative", "zero",
                                  "bf16_exact", "near_max"])
def test_split_targets_bf16_is_exact(case):
    """The three bf16 terms of an f32 target sum back to it bit for bit (in
    K1's order, t_lo first), and their products with any bf16 value sum to
    the f32 target's product exactly (float64)."""
    t = split_values(case)
    terms = k1.split_targets_bf16(t)
    for x in terms:
        assert x.dtype == torch.bfloat16 and x.shape == t.shape
        assert torch.isfinite(x).all()
    hi, mid, lo = (x.float() for x in terms)
    back = (lo + mid) + hi
    assert torch.equal(back.view(torch.int32), t.view(torch.int32))
    rng = np.random.default_rng(12)
    f = torch.from_numpy(rng.normal(size=64) * 2.0 ** rng.integers(-8, 8, 64))
    f = f.to(torch.bfloat16).double()
    if case == "near_max":   # keep the float64 products finite and normal
        f = f * 2.0 ** -200
    want = t.double()[:, None] * f[None]
    got = sum(x.double()[:, None] * f[None] for x in (lo, mid, hi))
    assert torch.equal(got, want)


def _bad(case):
    f, m, t, tm, w = as_torch(make_inputs(), torch.float32)
    if case == "feats_f64":
        f = f.double()
    elif case == "feats_3d":
        f = f[0]
    elif case == "mask_uint8":
        m = m.to(torch.uint8)
    elif case == "targets_bf16":
        t = t.to(torch.bfloat16)
    elif case == "targets_dim":
        t = t[..., :-1]
    elif case == "tmask_shape":
        tm = tm[:, :1]
    elif case == "weights_shape":
        w = w[:, :1]
    return f, m, t, tm, w


@pytest.mark.parametrize("case", ["feats_f64", "feats_3d", "mask_uint8",
                                  "targets_bf16", "targets_dim",
                                  "tmask_shape", "weights_shape"])
def test_wrapper_rejects_bad_operands(case):
    f, m, t, tm, w = _bad(case)
    with pytest.raises(ValueError):
        k1.fused_query_scores(f, m, t, tm, w)
    if case != "weights_shape":
        with pytest.raises(ValueError):
            port_batched(t, tm, f, m)


def test_wrapper_rejects_unknown_target_dtype():
    f, m, t, tm, _ = as_torch(make_inputs(), torch.float32)
    with pytest.raises(ValueError):
        k1.query_k1(f, m, t, tm, target_dtype=torch.float16)
