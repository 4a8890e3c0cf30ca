"""K1: fused multi-query ensemble similarity (``csrc/query_kernel.cu``).

Port of ``videoquery/kernels/query_pallas.py``. One streaming pass over the
index ``feats [S, K, N, D]`` computes, for Q targets at once, the masked
per-stream similarity sums and counts, then one of two epilogues:

- avg+counts: avg f32[Q, S, N] and counts int32[Q, S, N], the engine's
  batched similarity (``search.scoring.ensemble_similarities_batched``;
  targets stay f32, as the reference's einsum promotes a bf16 index times
  f32 targets to f32);
- ``fused_query_scores``: the weighted score f32[Q, N], -1e30 where a clip
  misses a stream (targets are first rounded to the index dtype, as the
  TPU kernel casts them). ``fused_query_topk`` adds ``torch.topk``.

``query_k1`` is the wrapper of both. A CUDA tensor launches the kernel, or
raises; a CPU tensor takes the plain PyTorch version beside it
(``*_reference``), which keeps the same
Q-independence: each query's similarities come from a product whose shape
does not depend on Q. ``LAUNCHES`` counts kernel launches.

On the card a bf16 index runs on the tensor cores (bf16 MMAs with f32
sums, the order of each output's k-steps fixed by D alone); f32 targets
reach it as three exact bf16 terms (``split_targets_bf16``). An f32 index
runs exact f32 FMAs on the CUDA cores. The source's header says more.
"""

from __future__ import annotations

import ctypes

import torch

from videoquery_torch.core.profiling import span
from videoquery_torch.kernels import _launch

NEG_INF = -1e30  # scores live in [-1, 1]; query_pallas.py NEG_INF

# kernel launches since import (or since a caller reset it)
LAUNCHES = 0

_FEAT_DTYPES = (torch.float32, torch.bfloat16)


def _check(feats, mask, targets, tmask, weights=None) -> None:
    if feats.dim() != 4 or feats.dtype not in _FEAT_DTYPES:
        raise ValueError(f"feats must be float32/bfloat16 [S, K, N, D]; got "
                         f"{feats.dtype} {tuple(feats.shape)}")
    s, k, n, d = feats.shape
    if mask.dtype != torch.bool or tuple(mask.shape) != (s, k, n):
        raise ValueError(f"mask must be bool [{s}, {k}, {n}]; got "
                         f"{mask.dtype} {tuple(mask.shape)}")
    if (targets.dtype != torch.float32 or targets.dim() != 4
            or tuple(targets.shape[1:]) != (s, k, d)):
        raise ValueError(f"targets must be float32 [Q, {s}, {k}, {d}]; got "
                         f"{targets.dtype} {tuple(targets.shape)}")
    q = targets.shape[0]
    if tmask.dtype != torch.bool or tuple(tmask.shape) != (q, s, k):
        raise ValueError(f"tmask must be bool [{q}, {s}, {k}]; got "
                         f"{tmask.dtype} {tuple(tmask.shape)}")
    if weights is not None and (weights.dtype != torch.float32
                                or tuple(weights.shape) != (q, s)):
        raise ValueError(f"weights must be float32 [{q}, {s}]; got "
                         f"{weights.dtype} {tuple(weights.shape)}")
    tensors = [feats, mask, targets, tmask] + ([weights] if weights is not None else [])
    if any(t.device != feats.device for t in tensors):
        raise ValueError("all operands must be on one device")


# -- plain PyTorch versions ---------------------------------------------------

def ensemble_similarities_batched_reference(
    targets: torch.Tensor,   # f32[Q, S, K, D]
    tmask: torch.Tensor,     # bool[Q, S, K]
    feats: torch.Tensor,     # [S, K, N, D] f32 | bf16
    mask: torch.Tensor,      # bool[S, K, N]
) -> tuple[torch.Tensor, torch.Tensor]:
    """avg f32[Q, S, N], counts int32[Q, S, N] (scoring.py:89-93 semantics).
    One [S*K, N, D] x [S*K, D, 1] product per query, and elementwise sums
    over splits, so a query's bits do not depend on the batch it is in."""
    s, k, n, d = feats.shape
    f = feats.float().reshape(s * k, n, d)
    sims = torch.stack([torch.bmm(f, t.reshape(s * k, d, 1)).reshape(s, k, n)
                        for t in targets])                   # [Q, S, K, N]
    m = mask[None] & tmask[..., None]                         # [Q, S, K, N]
    total = torch.zeros_like(sims[:, :, 0])
    counts = torch.zeros(total.shape, dtype=torch.int32, device=total.device)
    for ki in range(k):
        total = total + torch.where(m[:, :, ki], sims[:, :, ki], 0.0)
        counts = counts + m[:, :, ki].to(torch.int32)
    return total / counts.clamp(min=1).float(), counts


def _scores_epilogue(avg, counts, weights):
    """score = 1 - sqrt(sum_s (w_s(1-avg_s))^2 / sum_s w_s^2), NEG_INF where
    a stream has no member; sums over s in order, elementwise."""
    num = torch.zeros_like(avg[:, 0])
    den = torch.zeros_like(weights[:, 0])
    valid = torch.ones(num.shape, dtype=torch.bool, device=num.device)
    for si in range(avg.shape[1]):
        w = weights[:, si]
        dev = w[:, None] * (1.0 - avg[:, si])
        num = num + dev * dev
        den = den + w * w
        valid = valid & (counts[:, si] > 0)
    score = 1.0 - torch.sqrt(num / den[:, None])
    return torch.where(valid, score, torch.full_like(score, NEG_INF))


def query_k1_reference(feats, mask, targets, tmask, weights=None, *,
                       target_dtype: torch.dtype):
    """Plain version of query_k1 (same arguments, same results up to the
    order of the sums over D)."""
    t = targets.to(target_dtype).float()
    avg, counts = ensemble_similarities_batched_reference(t, tmask, feats, mask)
    if weights is None:
        return avg, counts
    return _scores_epilogue(avg, counts, weights)


def fused_query_scores_reference(feats, mask, targets, tmask, weights):
    """Plain version of fused_query_scores: f32[Q, N]."""
    return query_k1_reference(feats, mask, targets, tmask, weights,
                              target_dtype=feats.dtype)


# -- the kernel ---------------------------------------------------------------

_ENTRY = _launch.Entry("query_kernel.cu", "vq_query_launch", 16)
_max_q = 0  # vq_query_max_q(), read at the first launch


def split_targets_bf16(t: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """f32 targets as three bf16 terms (t_hi, t_mid, t_lo), each the
    round-to-nearest bf16 of what the terms before it leave, so that
    t_lo + t_mid + t_hi == t in f32, bit for bit, for every finite t with
    |t| >= 2**-110 or t == 0 (below, the last remainder may be finer than a
    bf16 subnormal). Where rounding t to bf16 would overflow (|t| within
    half a bf16 ulp of the f32 maximum) t_hi is t truncated instead. Every
    bf16 x bf16 product is exact in f32, so K1 takes an f32 target's
    products against a bf16 index as three MMAs."""
    hi = t.to(torch.bfloat16)
    chopped = (t.view(torch.int32) & -65536).view(torch.float32).to(torch.bfloat16)
    hi = torch.where(torch.isinf(hi) & torch.isfinite(t), chopped, hi)
    rest = t - hi.float()
    mid = rest.to(torch.bfloat16)
    lo = (rest - mid.float()).to(torch.bfloat16)
    return hi, mid, lo


def _launch_k1(feats, mask, targets, terms: int, tmask, weights, scores: bool):
    """Allocate the outputs and launch K1 on the current stream, in chunks
    of at most vq_query_max_q() queries (each query's result is the same in
    any chunk). targets: f32 [Q, S, K, D] for an f32 index, bf16
    [Q, terms, S, K, D] for a bf16 one."""
    global LAUNCHES, _max_q
    for t in (feats, mask, targets, tmask) + ((weights,) if scores else ()):
        if not t.is_contiguous():
            raise ValueError("K1 operands must be contiguous")
    s, k, n, d = feats.shape
    q = targets.shape[0]
    if n >= 2 ** 31 or d >= 2 ** 31:
        raise ValueError("N and D must fit in int32")
    if not _max_q:
        _ENTRY.load()
        max_q = _ENTRY.lib.vq_query_max_q
        max_q.argtypes, max_q.restype = [], ctypes.c_int
        _max_q = max_q()
    dev = feats.device
    if scores:
        out = torch.empty((q, n), dtype=torch.float32, device=dev)
        counts = None
    else:
        out = torch.empty((q, s, n), dtype=torch.float32, device=dev)
        counts = torch.empty((q, s, n), dtype=torch.int32, device=dev)
    bf16 = feats.dtype == torch.bfloat16
    # 16-byte copies: whole 16-byte pieces per row, 16-byte aligned bases
    # (each chunk of targets starts a whole number of rows in)
    vec = int(d % (8 if bf16 else 4) == 0 and feats.data_ptr() % 16 == 0
              and targets.data_ptr() % 16 == 0)
    index = feats.get_device()
    per_query = (targets, tmask, weights if scores else None, out, counts)
    # no tensor op between the span's first event and the launch, so its
    # device ms is K1's time
    with span("kernels.k1", dev):
        for q0 in range(0, q, _max_q):
            t_ptr, m_ptr, w_ptr, o_ptr, c_ptr = (_row(t, q0) for t in per_query)
            _launch.launch(
                _ENTRY, "K1", index, feats.data_ptr(), int(bf16), mask.data_ptr(),
                t_ptr, terms, m_ptr, w_ptr, o_ptr, c_ptr,
                min(q, q0 + _max_q) - q0, s, k, n, d, int(scores), vec)
            LAUNCHES += 1
    return out, counts


def _row(t, q0: int) -> int:
    """The address of ``t[q0]`` of a contiguous ``t`` (0 for None), with no
    tensor op."""
    return 0 if t is None else t.data_ptr() + q0 * t.stride(0) * t.element_size()


def _on_cuda(feats) -> bool:
    if feats.device.type == "cuda":
        return True
    if feats.device.type == "cpu":
        return False
    raise ValueError(f"K1 runs on CUDA or (plain version) the CPU, not {feats.device}")


def query_k1(feats, mask, targets, tmask, weights=None, *,
             target_dtype: torch.dtype):
    """One K1 pass. weights None: the avg+counts epilogue, (avg f32[Q, S, N],
    counts int32[Q, S, N]); weights f32[Q, S]: the scores epilogue, f32[Q, N].

    target_dtype is the targets' working type: they are rounded to it before
    the product. torch.float32 keeps them (the engine: the reference's einsum
    promotes a bf16 index times f32 targets to f32); feats.dtype is the TPU
    kernel's cast (query_pallas.py:50). The two differ on a bf16 index.

    On the card an f32 index runs K1's CUDA-core body on f32 targets; a
    bf16 index runs its tensor-core body on bf16 targets, one term when
    target_dtype is bf16 and the three of ``split_targets_bf16`` when it is
    f32, so that every product is exact either way."""
    _check(feats, mask, targets, tmask, weights)
    if target_dtype not in _FEAT_DTYPES:
        raise ValueError(f"target_dtype must be float32 or bfloat16, got {target_dtype}")
    if not _on_cuda(feats):
        with span("kernels.k1"):
            return query_k1_reference(feats, mask, targets, tmask, weights,
                                      target_dtype=target_dtype)
    if feats.dtype == torch.float32:
        t, terms = targets.to(target_dtype).float().contiguous(), 1
    elif target_dtype == torch.float32:
        t, terms = torch.stack(split_targets_bf16(targets), dim=1), 3
    else:
        t, terms = targets.to(torch.bfloat16)[:, None].contiguous(), 1
    out, counts = _launch_k1(feats, mask, t, terms, tmask, weights,
                             scores=weights is not None)
    return out if weights is not None else (out, counts)


def fused_query_scores(feats, mask, targets, tmask, weights) -> torch.Tensor:
    """K1's scores epilogue: f32[Q, N] (query_pallas.fused_query_scores);
    any N, the ragged edge is masked inside the kernel."""
    return query_k1(feats, mask, targets, tmask, weights, target_dtype=feats.dtype)


def fused_query_topk(feats, mask, targets, tmask, weights, k: int = 20):
    """Fused scores + top-k: (vals f32[Q, k], idx int64[Q, k])."""
    return torch.topk(fused_query_scores(feats, mask, targets, tmask, weights), k)
