"""T2 (videoquery_torch.kernels.roll) against the JAX package's roll repro.

On the CPU the wrapper runs T2's plain version (torch.roll). It is held here
against the repro's own Pallas kernel (``tools.mosaic_roll_repro.make_kernel``:
``pltpu.roll`` by a shift read from SMEM), which runs on the CPU in
interpret mode, on the repro's seeded [1, 80, 256] tile: axis 0 and 1, both
signs, shifts 1, 5 and 8, and shifts beyond the axis length. Equality is
exact: a roll moves values and rounds nothing. The CUDA kernel is held
against torch.roll by the `cuda` test in tests/test_torch_cuda_kernels.py
and by chip_smoke.py (the repro tool,
12 cases, each error 0).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from tools.mosaic_roll_repro import H, W, make_kernel
from videoquery_torch.kernels import roll as t2
from videoquery_torch.tools import roll_repro

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)


def tile():
    return np.random.default_rng(0).random((1, H, W)).astype(np.float32)


def pallas_roll(x, axis, negate, s):
    spec = pl.BlockSpec((1, H, W), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)
    sspec = pl.BlockSpec((1,), lambda i: (0,), memory_space=pltpu.SMEM)
    with pltpu.force_tpu_interpret_mode():
        out = pl.pallas_call(
            make_kernel(axis, negate), grid=(1,), in_specs=[spec, sspec], out_specs=spec,
            out_shape=jax.ShapeDtypeStruct((1, H, W), jnp.float32),
        )(jnp.asarray(x), jnp.asarray([s], jnp.int32))
    return np.asarray(out)


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("negate", [True, False])
@pytest.mark.parametrize("s", [1, 5, 8])
def test_plain_roll_matches_pallas_repro_kernel(axis, negate, s):
    x = tile()
    want = pallas_roll(x, axis, negate, s)
    got = t2.roll(torch.from_numpy(x), torch.tensor([-s if negate else s], dtype=torch.int32),
                  axis).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[0], np.roll(x[0], -s if negate else s, axis))


@pytest.mark.parametrize("shift", [0, 80, -80, 257, -261, 1000])
def test_shift_is_taken_modulo_the_axis_length(shift):
    x = torch.from_numpy(tile()).repeat(2, 1, 1)
    for axis in (0, 1):
        got = t2.roll(x, torch.tensor([shift], dtype=torch.int32), axis)
        want = np.roll(x.numpy(), shift, axis + 1)
        np.testing.assert_array_equal(got.numpy(), want)


def test_repro_tool_reports_twelve_exact_cases():
    lines = []
    errs = roll_repro.run("cpu", log=lines.append)
    assert errs == [0.0] * 12
    assert lines[0].startswith("axis=0 neg-shift") and len(lines) == 4


@pytest.mark.parametrize("case", ["x_f64", "x_2d", "shift_i64", "shift_two", "axis"])
def test_wrapper_rejects_bad_operands(case):
    x, shift, axis = torch.from_numpy(tile()), torch.tensor([3], dtype=torch.int32), 0
    if case == "x_f64":
        x = x.double()
    elif case == "x_2d":
        x = x[0]
    elif case == "shift_i64":
        shift = shift.long()
    elif case == "shift_two":
        shift = torch.tensor([3, 4], dtype=torch.int32)
    else:
        axis = 2
    with pytest.raises(ValueError):
        t2.roll(x, shift, axis)
