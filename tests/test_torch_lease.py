"""The port's state-3 lease recovery (videoquery_torch/service/lease.py),
which the port's broker runs every poll, in tests/test_lease.py's
scenarios: a broker killed mid-job (its client raises after the state-3
PATCH and the lease stamp), then recovery by a later poll.

Each scenario runs twice, once on the port (its FakeAPI, compute_matches
on the CPU, lease module) and once on the JAX package, and the API state
it leaves (queries, query results, matches; the wall-clock stamps in the
notes masked) must be the same.
"""

import json
import logging
import os
import random
import re
import time
import types

import pytest
import torch

from conftest import REFERENCE_FIXTURES
from test_broker_integration import fresh_query, seed_from_fixture
from videoquery.core.config import BrokerConfig as JaxBrokerConfig
from videoquery.core.config import HyperParams as JaxHyperParams
from videoquery.service import lease as jax_lease
from videoquery.service.compute_matches import compute_matches as jax_compute_matches
from videoquery.service.repository import APIRepository as JaxAPIRepository
from videoquery.testing import fake_api as jax_fake_api
from videoquery_torch.core.config import (STATE_IN_PROGRESS, STATE_PROCESSED,
                                          BrokerConfig, HyperParams)
from videoquery_torch.service import lease
from videoquery_torch.service.compute_matches import compute_matches
from videoquery_torch.service.repository import APIRepository
from videoquery_torch.testing import fake_api
from videoquery_torch.testing.fake_api import STATE_NEW_REQUESTED, STATE_REVISE_REQUESTED

# tier-1 runs 6 test workers on 8 CPUs: two intra-op threads each keep torch
# from starving the timing tests that share the machine
torch.set_num_threads(2)

FIXTURE = os.path.join(REFERENCE_FIXTURES, "stock-video-clips_features")

PORT = types.SimpleNamespace(
    fake=fake_api, lease=lease, repo=APIRepository,
    broker_config=BrokerConfig, logger="videoquery_torch.service.lease",
    compute=lambda repo, **kw: compute_matches(repo, HyperParams(), device="cpu", **kw))
JAX = types.SimpleNamespace(
    fake=jax_fake_api, lease=jax_lease, repo=JaxAPIRepository, broker_config=JaxBrokerConfig,
    logger="videoquery.service.lease",
    compute=lambda repo, **kw: jax_compute_matches(repo, JaxHyperParams(), **kw))


def world(pkg):
    """A FakeAPI of `pkg` seeded from the fixture CSVs, and one fresh query
    over every clip (tests/test_broker_integration.py's helpers)."""
    if not os.path.isdir(FIXTURE):
        pytest.skip("reference fixtures unavailable")
    api = pkg.fake.FakeAPI()
    videos, clip_ids = seed_from_fixture(api)
    return api, fresh_query(api, videos, clip_ids)["id"]


def poll(pkg, api, client=None):
    pkg.compute(pkg.repo(client or pkg.fake.FakeClient(api), "fake://"),
                rng=random.Random(0), exact=True)


def crash_mid_job(pkg, api):
    """One poll through a client that raises on its first search-set
    features call, after the state-3 PATCH and the stamp: what a killed
    broker leaves."""
    class CrashingClient(pkg.fake.FakeClient):
        crashed = False

        def action(self, action, params=None, encoding=None):
            if tuple(action) == ("search-sets", "features") and not self.crashed:
                self.crashed = True
                raise RuntimeError("broker killed mid-job")
            return super().action(action, params, encoding)

    poll(pkg, api, CrashingClient(api))


def state(api) -> str:
    """The API's queries, query results and matches; the notes' wall-clock
    stamps and ages masked."""
    def notes(text):
        text = re.sub(r"since [0-9.]+ \([^)]*\)", "since <t>", text or "")
        return re.sub(r"after [0-9]+s", "after <age>s", text)

    queries = {k: dict(q, notes=notes(q.get("notes"))) for k, q in api.queries.items()}
    return json.dumps({"queries": queries, "query_results": api.query_results,
                       "matches": api.matches}, sort_keys=True, default=str)


def on_both(scenario):
    """scenario(pkg) on the port, then on the JAX package: the same
    observations and the same API state."""
    ours, theirs = scenario(PORT), scenario(JAX)
    assert ours == theirs
    return ours


def test_crashed_new_job_recovered_and_reprocessed():
    def scenario(pkg):
        api, qid = world(pkg)
        crash_mid_job(pkg, api)
        q = api.queries[qid]
        assert q["process_state"] == STATE_IN_PROGRESS
        assert "[lease] processing new since" in q["notes"]
        client = pkg.fake.FakeClient(api)    # a fresh broker polls later
        rec = pkg.lease.LeaseRecovery(client, lease_seconds=300.0)
        assert rec.recover(now=time.time() + 10) == []        # within the lease
        assert api.queries[qid]["process_state"] == STATE_IN_PROGRESS
        assert rec.recover(now=time.time() + 301) == [qid]    # past it
        q = api.queries[qid]
        assert q["process_state"] == STATE_NEW_REQUESTED
        assert "[lease] reset to state 1" in q["notes"]
        after_reset = state(api)
        poll(pkg, api, client)
        assert api.queries[qid]["process_state"] == STATE_PROCESSED
        assert any(r["query"] == qid for r in api.query_results.values())
        return after_reset, state(api)

    on_both(scenario)


def test_crashed_revise_job_resets_to_revise_state():
    def scenario(pkg):
        api, qid = world(pkg)
        client = pkg.fake.FakeClient(api)
        poll(pkg, api, client)
        assert api.queries[qid]["process_state"] == STATE_PROCESSED
        for m in list(api.matches.values())[:3]:
            api.set_user_match(m["id"], True)
        api.request_revision(qid)
        crash_mid_job(pkg, api)
        assert api.queries[qid]["process_state"] == STATE_IN_PROGRESS
        rec = pkg.lease.LeaseRecovery(client, lease_seconds=60.0)
        assert rec.recover(now=time.time() + 61) == [qid]
        assert api.queries[qid]["process_state"] == STATE_REVISE_REQUESTED
        after_reset = state(api)
        n_rounds = sum(r["query"] == qid for r in api.query_results.values())
        poll(pkg, api, client)
        assert api.queries[qid]["process_state"] == STATE_PROCESSED
        assert sum(r["query"] == qid for r in api.query_results.values()) == n_rounds + 1
        return after_reset, state(api)

    on_both(scenario)


def test_recovery_is_idempotent_across_brokers():
    def scenario(pkg):
        api, qid = world(pkg)
        crash_mid_job(pkg, api)
        client = pkg.fake.FakeClient(api)
        now = time.time() + 1000
        assert pkg.lease.LeaseRecovery(client, 60.0).recover(now=now) == [qid]
        # a second broker racing the same expired lease finds nothing in state 3
        assert pkg.lease.LeaseRecovery(client, 60.0).recover(now=now) == []
        assert api.queries[qid]["process_state"] == STATE_NEW_REQUESTED
        return state(api)

    on_both(scenario)


def test_stamp_replaces_previous_stamp():
    def scenario(pkg):
        api, qid = world(pkg)
        client = pkg.fake.FakeClient(api)
        pkg.lease.stamp(client, qid, "new", now=1000.0)
        pkg.lease.stamp(client, qid, "revise", now=2000.0)
        notes = api.queries[qid]["notes"]
        assert notes.count("[lease] processing") == 1
        assert "revise since 2000" in notes
        return notes, state(api)

    on_both(scenario)


def test_no_breadcrumb_falls_back_to_first_seen_clock():
    def scenario(pkg):
        api, qid = world(pkg)
        # a foreign writer (or a pre-lease broker) strands the job unstamped
        api.queries[qid]["process_state"] = STATE_IN_PROGRESS
        rec = pkg.lease.LeaseRecovery(pkg.fake.FakeClient(api), lease_seconds=100.0)
        t0 = time.time()
        assert rec.recover(now=t0) == []          # starts the clock
        assert rec.recover(now=t0 + 50) == []     # not yet expired
        assert rec.recover(now=t0 + 101) == [qid]
        # no query_results -> it was a new job
        assert api.queries[qid]["process_state"] == STATE_NEW_REQUESTED
        return state(api)

    on_both(scenario)


def test_lease_disabled_leaves_state_3_alone():
    def scenario(pkg):
        api, qid = world(pkg)
        crash_mid_job(pkg, api)
        rec = pkg.lease.LeaseRecovery(pkg.fake.FakeClient(api), lease_seconds=0.0)
        assert rec.recover(now=time.time() + 1e6) == []
        assert api.queries[qid]["process_state"] == STATE_IN_PROGRESS
        return state(api)

    on_both(scenario)


def test_broker_config_lease_env(monkeypatch):
    monkeypatch.setenv("BROKER_LEASE_SECONDS", "42.5")
    assert on_both(lambda pkg: pkg.broker_config.from_env().lease_seconds) == 42.5


def test_missing_list_route_warns_once_and_disables(caplog):
    """An API without the `queries list?process_state=` route: recovery off
    with one WARNING, the same text from both packages."""
    class NoListClient:
        def action(self, action, params=None, encoding=None):
            if tuple(action) == ("queries", "list"):
                raise KeyError("no such route")
            raise AssertionError("recovery must only probe queries/list")

    def scenario(pkg):
        caplog.clear()
        rec = pkg.lease.LeaseRecovery(NoListClient(), lease_seconds=300.0)
        with caplog.at_level(logging.WARNING, logger=pkg.logger):
            assert rec.recover(now=1000.0) == []
            assert rec.recover(now=2000.0) == []
        warnings = [r.getMessage() for r in caplog.records
                    if r.name == pkg.logger and "lease recovery disabled" in r.getMessage()]
        assert len(warnings) == 1
        assert "process_state" in warnings[0]
        return warnings

    on_both(scenario)
