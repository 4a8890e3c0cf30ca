"""A run whose timed path is broken underneath comes out not correct: for
each fault the cell can have, planted in the program at a tiny size on the
CPU (the harness's look for a card is skipped there, the rest of a run is
driven). The cells run on one card, so none has an exchange between chips
to leave out."""

import pytest
import torch

from benchmark.tests import _small


def _incorrect(cell):
    r = _small.execute(cell)
    assert not r["correct"], r["checks"]
    return r["checks"]


# -- the rounds -----------------------------------------------------------------

@pytest.fixture
def engine(monkeypatch):
    from videoquery_torch.search import engine
    return engine


@pytest.mark.parametrize("cell", ["rounds_cone_q8", "rounds_cone_q1"])
def test_round_fit_returns_its_state_unchanged(cell, monkeypatch, engine):
    """The optimizer's step returns the round state it was given."""
    def unchanged(hp, sim, labels):
        return hp.reset_round_state(), None
    monkeypatch.setattr(engine, "_round_state", unchanged)
    assert _incorrect(cell)["fit_loss_gap"]["value"] > 0


@pytest.mark.parametrize("cell", ["rounds_cone_q8", "rounds_cone_q1"])
def test_round_similarity_over_half_the_splits(cell, monkeypatch, engine):
    """Half of the ensemble left out: the mean taken over the first split."""
    real = engine.ensemble_similarities_batched

    def half(targets, tmask, feats, mask):
        tm = tmask.clone()
        tm[:, :, 1:] = False
        return real(targets, tm, feats, mask)
    monkeypatch.setattr(engine, "ensemble_similarities_batched", half)
    checks = _incorrect(cell)
    assert checks["score_gap"]["value"] > checks["score_gap"]["limit"]


def test_round_half_the_group_left_out(monkeypatch, engine):
    """Half of a poll group's queries scored, the others given their
    results."""
    real = engine.ensemble_similarities_batched

    def half(targets, tmask, feats, mask):
        q = targets.shape[0]
        keep = torch.arange(q) % max(1, q // 2)
        return real(targets[keep].contiguous(), tmask[keep].contiguous(), feats, mask)
    monkeypatch.setattr(engine, "ensemble_similarities_batched", half)
    _incorrect("rounds_cone_q8")


@pytest.mark.parametrize("cell", ["rounds_cone_q8", "rounds_cone_q1"])
def test_round_score_altered_where_produced(cell, monkeypatch, engine):
    real = engine._scores_f64

    def altered(avg, w):
        out = real(avg, w)
        if out.size:
            out[0] += 1e-3
        return out
    monkeypatch.setattr(engine, "_scores_f64", altered)
    assert _incorrect(cell)["score_gap"]["value"] > 5e-4


def test_round_selection_altered_where_produced(monkeypatch):
    from benchmark.loops import rounds
    import videoquery_torch.search.selection as selection

    real = selection.select_clips_to_review

    def altered(scores, *a, **k):
        out = real(scores, *a, **k)
        lowest = min(scores, key=scores.get)      # a clip far below the band's top
        out[lowest] = scores[lowest]
        return out
    monkeypatch.setattr(selection, "select_clips_to_review", altered)
    assert _incorrect("rounds_cone_q8")["selection_faults"]["value"] > 0


# -- the query ------------------------------------------------------------------

def test_query_half_the_batch_left_out(monkeypatch):
    import videoquery_torch.kernels.query as k1

    real = k1.fused_query_topk

    def half(feats, mask, targets, tmask, weights, k=20):
        q = targets.shape[0]
        keep = torch.arange(q) % (q // 2)
        return real(feats, mask, targets[keep].contiguous(), tmask[keep].contiguous(),
                    weights[keep].contiguous(), k)
    monkeypatch.setattr(k1, "fused_query_topk", half)
    _incorrect("query_b16")


def test_query_answer_altered_where_produced(monkeypatch):
    import videoquery_torch.kernels.query as k1

    real = k1.fused_query_topk

    def altered(*a, **k):
        vals, ids = real(*a, **k)
        ids = ids.clone()
        ids[0, 0] = ids[0, -1] + 1
        return vals, ids
    monkeypatch.setattr(k1, "fused_query_topk", altered)
    _incorrect("query_b16")


# -- extraction -----------------------------------------------------------------

def test_extract_flow_returns_its_state_unchanged(monkeypatch):
    """Each TV-L1 level returns the flow it was given."""
    import videoquery_torch.kernels.tvl1_flow as flow

    monkeypatch.setattr(flow, "tvl1_level", lambda i0, i1, u, v, p, d: (u, v))
    checks = _incorrect("extract_textured")
    assert checks["flow_rel_err"]["value"] > checks["flow_rel_err"]["limit"]


def test_extract_half_the_ticks_left_out(monkeypatch):
    """Half of a clip's ticks left out, the mean taken over the rest."""
    import videoquery_torch.pipeline.extract as ex

    real = ex._stream_embed

    def half(stream, x, mesh=None):
        return real(stream, x[:, : max(1, x.shape[1] // 2)].contiguous(), mesh)
    monkeypatch.setattr(ex, "_stream_embed", half)
    _incorrect("extract_textured")


def test_extract_signature_altered_where_produced(monkeypatch):
    import videoquery_torch.pipeline.extract as ex

    real = ex.extract_step

    def altered(*a, **k):
        rgb, flow = real(*a, **k)
        rgb = rgb.clone()
        rgb[:, 0] = -rgb[:, 0]
        return rgb, flow
    monkeypatch.setattr(ex, "extract_step", altered)
    checks = _incorrect("extract_textured")
    assert checks["rgb_rel_err"]["value"] > checks["rgb_rel_err"]["limit"]
