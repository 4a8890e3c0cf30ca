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
the plain version by the `cuda` tests in tests/test_torch_cuda_kernels.py
and by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from _torch_cases import block_params, relu_input
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


def test_bf16_agreement_counts_one_ulp_of_the_larger_value():
    """T1's bf16 criterion (``bench.bf16_agreement``, used here and on the
    card): one ulp is that of the larger magnitude, 2**-7 in [1, 2) and
    2**-6 in [2, 4); the second number is max |diff| over max |want|."""
    got = torch.tensor([1.0, 1.0, 1.9921875, 0.0, 3.0])
    want = torch.tensor([1.0078125, 1.015625, 2.0, 0.0, 3.0])
    share, rel = bench.bf16_agreement(got, want)
    assert share == pytest.approx(4 / 5) and rel == pytest.approx(0.015625 / 3.0)


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
    share, rel = bench.bf16_agreement(got, torch.from_numpy(want))
    assert share >= bench.BF16_SHARE and rel <= bench.BF16_REL, (share, rel)


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
