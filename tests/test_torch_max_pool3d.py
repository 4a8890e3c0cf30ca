"""P1, I3D's max pool (``videoquery_torch/kernels/max_pool3d.py``), on the
CPU: the wrapper's plain version at every pool shape of the net against the
plain reference's ``F.max_pool3d`` over an explicit -inf ``F.pad``
(``videoquery_torch/testing/i3d_reference.py``), bit for bit (a max rounds
nothing), with -inf and NaN planted; its argument checks; and the pools'
spans and launch counter in a CPU forward. The kernel itself runs only on
the card (``tests/test_torch_cuda_kernels.py``)."""

import math

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from videoquery_torch.core import profiling
from videoquery_torch.kernels import max_pool3d as p1
from videoquery_torch.nn import i3d
from videoquery_torch.testing import i3d_reference as ref

# tier-1 runs 6 test workers on 8 CPUs
torch.set_num_threads(2)

# one volume of an even and of an odd size: every pool at small T, H, W
SIZES = {"even": (16, 64, 64), "odd": (15, 63, 65)}
POOLS = [layer[0] for layer in i3d.pool_shapes(1, *SIZES["even"])]


def planted(shape, dtype, seed):
    """Channels-last-3d values in [-1, 1) with some -inf and NaN cells."""
    g = torch.Generator().manual_seed(seed)
    x = torch.rand(shape, generator=g) * 2 - 1
    cells = torch.rand(shape, generator=g)
    x[cells < 0.01] = -math.inf
    x[cells > 0.997] = math.nan
    return x.to(dtype).contiguous(memory_format=torch.channels_last_3d)


def same_bits(got: torch.Tensor, want: torch.Tensor) -> bool:
    nan = want.isnan()
    return (got.shape == want.shape and torch.equal(got.isnan(), nan)
            and torch.equal(got.masked_fill(nan, 0), want.masked_fill(nan, 0)))


def test_the_net_has_13_pools_of_four_kinds():
    pools = i3d.pool_shapes(8, 250, 224, 224)
    assert len(pools) == 13
    assert {(k, s) for _n, _x, k, s in pools} == {
        ((1, 3, 3), (1, 2, 2)), ((3, 3, 3), (1, 1, 1)), ((3, 3, 3), (2, 2, 2)),
        ((2, 2, 2), (2, 2, 2))}
    assert pools[0][1] == (8, 64, 125, 112, 112)
    assert pools[-1][1] == (8, 832, 32, 7, 7)
    # the flow stream's 249 frames give the same shapes after the stem
    assert [p[1] for p in i3d.pool_shapes(8, 249, 224, 224)] == [p[1] for p in pools]


def test_the_forward_pools_at_the_listed_shapes(monkeypatch):
    seen = []
    real = p1.max_pool_same

    def spy(x, k, s):
        seen.append((tuple(x.shape), tuple(k), tuple(s)))
        return real(x, k, s)

    monkeypatch.setattr(p1, "max_pool_same", spy)
    for frames, h, w in SIZES.values():
        seen.clear()
        net = i3d.InceptionI3d(i3d.init_params(1, 2))
        net.embed(torch.rand(2, frames, h, w, 2))
        assert seen == [(x, k, s) for _n, x, k, s in i3d.pool_shapes(2, frames, h, w)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("size", sorted(SIZES))
@pytest.mark.parametrize("pool", POOLS)
def test_the_plain_pool_equals_the_reference_bit_for_bit(pool, size, dtype):
    [(_n, shape, k, s)] = [p for p in i3d.pool_shapes(1, *SIZES[size]) if p[0] == pool]
    x = planted(shape, dtype, seed=shape[1])
    got = i3d.max_pool_same(x, k, s)
    assert got.dtype == dtype
    assert got.is_contiguous(memory_format=torch.channels_last_3d)
    assert got.shape[2:] == tuple(-(-d // st) for d, st in zip(shape[2:], s))
    assert same_bits(got, ref.max_pool(x, k, s))
    assert got.isnan().any()            # NaN propagates


@pytest.mark.parametrize("bad", ["float16", "int", "meta", "rank4", "kernel", "stride"])
def test_the_argument_checks_raise(bad):
    x = planted((1, 8, 4, 6, 6), torch.float32, seed=0)
    k, s = (3, 3, 3), (1, 1, 1)
    if bad == "float16":
        x = x.half()
    elif bad == "int":
        x = x.nan_to_num(0, 0, 0).to(torch.int32)
    elif bad == "meta":
        x = x.to("meta")
    elif bad == "rank4":
        x = x[0].contiguous()
    elif bad == "kernel":
        k = (3, 3)
    else:
        s = (1, 0, 1)
    before = p1.LAUNCHES
    with pytest.raises(ValueError):
        p1.max_pool_same(x, k, s)
    assert p1.LAUNCHES == before


@pytest.mark.parametrize("k, s", [((3, 3, 3), (1, 1, 1)), ((1, 3, 3), (1, 2, 2))])
def test_the_plain_pool_takes_any_layout(k, s):
    """The CPU's plain version pools an NCDHW input as its channels-last-3d
    copy (only the kernel on the card needs that layout)."""
    x = planted((2, 8, 5, 9, 10), torch.float32, seed=1)
    assert same_bits(p1.max_pool_same(x.contiguous(), k, s), p1.max_pool_same(x, k, s))


def test_a_cpu_forward_spans_each_pool_and_launches_nothing(monkeypatch):
    monkeypatch.setattr(profiling, "_state", profiling._State())
    net = i3d.InceptionI3d(i3d.init_params(2, 3))
    x = torch.rand(1, 15, 63, 65, 3)
    before = p1.LAUNCHES
    with profile(activities=[ProfilerActivity.CPU]):
        net.embed(x)
    rec = profiling.trace_record()
    by_id = {s.id: s for s in rec.spans}
    pools = [s for s in sorted(rec.spans, key=lambda s: s.start_ns) if s.name == "i3d.pool"]
    assert [by_id[s.parent].name for s in pools] == ["i3d.stem"] * 2 + ["i3d.mixed"] * 11
    assert all(s.device_ms is None for s in pools)
    assert rec.counters["i3d.pool_launches"] == 0
    assert p1.LAUNCHES == before
