"""T1 (videoquery_torch.kernels.inception_block) against the JAX package.

On the CPU the wrapper runs T1's plain PyTorch version. It is held here
against the TPU kernel ``tools.inception_pallas.fused_inception`` run in
interpret mode and against the JAX package's unfused block
``bn_inception._inception``, on the cases of tests/test_pallas.py: block 3a
with Cin 256 at 28x28 (AVE pool, 1x1 branch) and 5b with Cin 1024 at 7x7
(MAX pool), 5 ReLU'd images, the 1x1 weights redrawn at scale 0.05. Also
the stacked-member form (3 members with different weights) against the JAX
``vmap``. Tolerances: f32 rtol 1e-5 / atol 1e-5 (only the order of sums
differs); bf16 against the TPU kernel in bf16 (both round r3, rd, d1 and the
output to bf16 at the same places): >= 99% of outputs within one bf16 ulp,
max |diff| <= 1/64 of the largest output. The CUDA kernel is held against
the plain version by the `cuda` tests and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from tools.inception_pallas import fused_inception as jax_fused
from videoquery.nn import bn_inception as jbi
from videoquery_torch.kernels import inception_block as t1
from videoquery_torch.tools import inception_block_bench as bench

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)


RTOL, ATOL = 1e-5, 1e-5
CASES = [("inception_3a", 256, 28), ("inception_5b", 1024, 7)]


def block_params(name, cin, seed=0, members=None):
    """The block's parameters (numpy, JAX layout) as tests/test_pallas.py
    draws them; with members, a stacked tree whose member m scales every
    weight by 1 + 0.1 m."""
    rng = np.random.default_rng(seed)
    base = jbi.init_params(0, 3)
    p = {}
    for lyr in ("1x1", "3x3_reduce", "double_3x3_reduce", "pool_proj"):
        key = f"{name}/{lyr}"
        cout = base[key]["w"].shape[3]
        p[key] = {"w": (rng.normal(size=(1, 1, cin, cout)) * 0.05).astype(np.float32),
                  "b": (rng.normal(size=cout) * 0.01).astype(np.float32)}
    for lyr in ("3x3", "double_3x3_1", "double_3x3_2"):
        key = f"{name}/{lyr}"
        p[key] = {"w": np.asarray(base[key]["w"]),
                  "b": (rng.normal(size=base[key]["b"].shape) * 0.01).astype(np.float32)}
    if members is None:
        return p
    return {k: {"w": np.stack([v["w"] * (1 + 0.1 * m) for m in range(members)]),
                "b": np.stack([v["b"] * (1 + 0.1 * m) for m in range(members)])}
            for k, v in p.items()}


def relu_input(hw, cin, n=5, seed=1):
    x = np.random.default_rng(seed).normal(size=(n, hw, hw, cin)) * 0.3
    return np.maximum(x, 0.0).astype(np.float32)


def jax_tree(p, dtype=jnp.float32):
    return jax.tree.map(lambda a: jnp.asarray(a, dtype), p)


@pytest.mark.parametrize("name,cin,hw", CASES)
def test_plain_matches_pallas_kernel_and_unfused_block(name, cin, hw):
    spec = dict(jbi.INCEPTION_BLOCKS)[name]
    p = block_params(name, cin)
    x = relu_input(hw, cin)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused(jax_tree(p), name, spec, jnp.asarray(x), group=2))
    unfused = np.asarray(jbi._inception(jax_tree(p), name, spec, jnp.asarray(x)))
    got = t1.fused_inception(p, name, spec, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, hw, hw, spec["c1"] + spec["c3"] + spec["d2"]
                                       + spec["pp"])
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_allclose(got, unfused, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name,cin,hw", CASES)
def test_stacked_members_match_jax_vmap(name, cin, hw):
    spec = dict(jbi.INCEPTION_BLOCKS)[name]
    p3 = block_params(name, cin, seed=2, members=3)
    x = relu_input(hw, cin, n=2, seed=3)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax.vmap(lambda q: jax_fused(q, name, spec, jnp.asarray(x),
                                                       group=2))(jax_tree(p3)))
    got = t1.fused_inception(p3, name, spec, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.shape[0] == 3
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def bf16_agreement(got: np.ndarray, want: np.ndarray) -> tuple[float, float]:
    """(share of outputs within one bf16 ulp of each other, max |diff| over
    the largest |value|): the bf16 criterion of T1 here and on the card."""
    top = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(top > 0, 2.0 ** (np.floor(np.log2(np.maximum(top, 1e-30))) - 7), 0.0)
    diff = np.abs(got - want)
    return float((diff <= ulp).mean()), float(diff.max() / np.abs(want).max())


def test_plain_bf16_matches_pallas_kernel_in_bf16():
    name, cin, hw = CASES[0]
    spec = dict(jbi.INCEPTION_BLOCKS)[name]
    p = block_params(name, cin, seed=4)
    x = relu_input(hw, cin, n=2, seed=5)
    xb = jnp.asarray(x, jnp.bfloat16)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jax_fused(jax_tree(p), name, spec, xb, group=2)
                          .astype(jnp.float32))
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    got = t1.fused_inception(p, name, spec, xt)
    assert got.dtype == torch.bfloat16
    share, rel = bf16_agreement(got.float().numpy(), want)
    assert share >= 0.99 and rel <= 1 / 64, (share, rel)


def test_block_geometry_walks_the_jax_blocks():
    """block_geometry() equals a walk of the JAX package's INCEPTION_BLOCKS
    (the JAX tool's own function, which cannot be imported here: it sets up
    JAX at import)."""
    hw, cin, want = 28, 192, {}
    for name, b in jbi.INCEPTION_BLOCKS:
        want[name] = (hw, cin, b)
        cout = (b["c1"] + b["c3"] + b["d2"] + b["pp"] if b["stride"] == 1
                else b["c3"] + b["d2"] + cin)
        hw //= b["stride"]
        cin = cout
    assert bench.block_geometry() == want
    assert bench.stride1_blocks() == [n for n, b in jbi.INCEPTION_BLOCKS if b["stride"] == 1]
    assert len(bench.stride1_blocks()) == 8


def test_block_work_counts_the_seven_convs():
    """The A/B's bound: 3 x 200 bf16 images over the 8 stride-1 blocks do
    1.49 TFLOP against 1.63 GB of compulsory bytes, bound by operations at
    ~1.5 ms on the H100 SXM's 989 TFLOP/s."""
    rows = [bench.block_work(*bench.block_geometry()[n], 200, 3, torch.bfloat16)
            for n in bench.stride1_blocks()]
    assert all(r["bound_by"] == "operations" for r in rows)
    assert sum(r["flops"] for r in rows) == pytest.approx(1.4945e12, rel=1e-4)
    assert sum(r["bytes"] for r in rows) == pytest.approx(1.6335e9, rel=1e-4)
    assert sum(r["bound_ms"] for r in rows) == pytest.approx(1.511, rel=1e-3)


@pytest.mark.parametrize("case", ["stride2", "cin", "dtype", "rank", "weights_dtype"])
def test_wrapper_rejects_bad_operands(case):
    name, cin, hw = "inception_5b", 1024, 7
    spec = dict(jbi.INCEPTION_BLOCKS)[name]
    p = block_params(name, cin)
    x = torch.from_numpy(relu_input(hw, cin, n=1))
    if case == "stride2":
        name, spec = "inception_4e", dict(jbi.INCEPTION_BLOCKS)["inception_4e"]
        p = {k.replace("inception_5b", name): v for k, v in p.items()}
    elif case == "cin":
        x = x[..., :512].contiguous()
    elif case == "dtype":
        x = x.double()
    elif case == "rank":
        x = x[0]
    else:
        p = t1.block_weights(p, name, spec, torch.bfloat16, "cpu")
    with pytest.raises(ValueError):
        t1.fused_inception(p, name, spec, x)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cuda_kernel_matches_plain_version(dtype):
    """T1 against its plain version on the card at 3a's and 5b's shapes,
    3 members, 3 images; one launch per call."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; T1 has no CPU or interpret mode")
    torch.backends.cudnn.allow_tf32 = False
    for name, cin, hw in CASES:
        spec = dict(jbi.INCEPTION_BLOCKS)[name]
        wts = t1.block_weights(block_params(name, cin, members=3), name, spec, dtype, "cuda")
        x = torch.from_numpy(relu_input(hw, cin, n=3)).cuda().to(dtype)
        launches = t1.LAUNCHES
        got = t1.fused_inception(wts, name, spec, x)
        assert t1.LAUNCHES == launches + 1
        want = t1.fused_inception_reference(wts, name, spec, x)
        if dtype == torch.float32:
            torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-5)
        else:
            share, rel = bf16_agreement(got.float().cpu().numpy(), want.float().cpu().numpy())
            assert share >= 0.99 and rel <= 1 / 64, (share, rel)
