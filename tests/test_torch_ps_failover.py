"""The port's replicated parameter server on the CPU: warm-standby
replication, promotion, failover edges and the durability gate — the
port counterparts of the JAX package's standby tests, plus the
post-mortem bundle a promotion writes.

Every server binds ``127.0.0.1:0``; every wait is a bounded poll (steps
of 0.02 s, deadlines of 5 s); retry budgets and dial timeouts stay at
2 s. A "killed" primary is ``SocketParameterServer.kill()``: listener and
connections dropped with an RST, as a dying process would."""

import json
import sys
from pathlib import Path

import numpy as np
import pytest

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.obs import latest_postmortem
from distkeras_tpu_torch.parameter_servers import (
    DeltaParameterServer,
    DynSGDParameterServer,
    ParameterServerError,
    RemoteParameterServerClient,
    SocketParameterServer,
    StandbyError,
)

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_socket_ps import _params, _policy, _wait  # noqa: E402


def _client(*servers, **kw):
    c = RemoteParameterServerClient(
        endpoints=[("127.0.0.1", s.port) for s in servers], **kw)
    c.dial_timeout = 2.0
    return c


def _pair(ps_cls=DeltaParameterServer, v=0.0, **standby_kw):
    """(primary, standby) started and synced."""
    primary = SocketParameterServer(ps_cls(_params(v)), host="127.0.0.1")
    primary.start()
    standby = SocketParameterServer(
        ps_cls(_params(v)), host="127.0.0.1",
        standby_of=("127.0.0.1", primary.port), **standby_kw)
    standby.start()
    return primary, standby


def test_attach_streams_snapshot_then_commits_consistently():
    primary = SocketParameterServer(DeltaParameterServer(_params()),
                                    host="127.0.0.1")
    primary.start()
    try:
        client = _client(primary)
        snap_payload = {"params": _params(9.0), "seq": np.int64(1)}
        client.commit(_params(1.0), commit_id=(0, 0), local_snap=snap_payload)
        client.commit(_params(1.0), commit_id=(1, 0))
        standby = SocketParameterServer(
            DeltaParameterServer(_params()), host="127.0.0.1",
            standby_of=("127.0.0.1", primary.port))
        standby.start()  # synchronous first sync
        try:
            assert standby.role == "standby"
            np.testing.assert_array_equal(standby.ps.get_params()["w"],
                                          primary.ps.get_params()["w"])
            # the pre-attach worker snapshot rode the snapshot
            snaps = standby.ps.worker_snapshots()
            np.testing.assert_array_equal(snaps[0]["params"]["w"], 9.0)
            # post-attach commits stream through, dedup table included
            client.commit(_params(2.0), commit_id=(0, 1))
            np.testing.assert_array_equal(standby.ps.get_params()["w"],
                                          primary.ps.get_params()["w"])
            assert standby.ps._seen_seq == primary.ps._seen_seq
            assert primary.ps.num_replicas == 1
            kinds = [e["kind"] for e in primary.ps.recorder.snapshot()]
            assert kinds.count("ps.attach") == 1
            assert [e["kind"] for e in standby.ps.recorder.snapshot()][:1] \
                == ["ps.sync"]
        finally:
            standby.stop()
        client.close()
    finally:
        primary.stop()


def test_standby_refuses_clients_until_promoted():
    primary, standby = _pair()
    try:
        direct = _client(standby)
        with pytest.raises(StandbyError):
            direct.pull()
        with pytest.raises(StandbyError):
            direct.commit(_params(1.0), commit_id=(0, 0))
        # observable in both roles
        assert direct.metrics()["role"] == "standby"
        standby.promote(reason="test")
        center, _ = direct.pull()
        np.testing.assert_array_equal(center["w"], 0.0)
        assert direct.metrics()["role"] == "primary"
        direct.close()
    finally:
        standby.stop()
        primary.stop()


def test_promotion_with_inflight_commit_resend_is_deduped():
    """A commit applied (and replicated) whose ack was lost to the
    primary's death is RESENT to the promoted standby and deduped —
    applied exactly once across the failover."""
    primary, standby = _pair()
    client = _client(primary, standby, retry=_policy())
    try:
        client.commit(_params(1.0), commit_id=(0, 0))  # applied + replicated
        primary.kill()  # ...and the worker never hears the ack
        client.commit(_params(1.0), commit_id=(0, 0))  # transparent resend
        client.commit(_params(1.0), commit_id=(0, 1))  # new work continues
        assert _wait(lambda: standby.promoted)
        assert standby.promote_reason == "primary-lost"
        np.testing.assert_array_equal(standby.ps.get_params()["w"], 2.0)
        assert standby.ps.num_updates == 2
        assert standby.ps.num_duplicates == 1
        assert client.failovers >= 1
    finally:
        client.close()
        standby.stop()


def test_double_failover_through_rejoined_primary():
    """primary A -> standby B promotes -> A rejoins as A2 (standby of B)
    -> B dies -> A2 promotes; the ledger stays exact across both hops."""
    a, b = _pair()
    client = _client(a, b, retry=_policy())
    client.commit(_params(1.0), commit_id=(0, 0))
    a.kill()
    client.commit(_params(1.0), commit_id=(0, 1))  # fails over to B
    assert _wait(lambda: b.promoted)
    a2 = SocketParameterServer(DeltaParameterServer(_params()),
                               host="127.0.0.1",
                               standby_of=("127.0.0.1", b.port))
    a2.start()
    try:
        np.testing.assert_array_equal(a2.ps.get_params()["w"], 2.0)
        client.commit(_params(1.0), commit_id=(0, 2))  # replicates to a2
        b.kill()
        client2 = _client(b, a2, retry=_policy())
        client2.commit(_params(1.0), commit_id=(0, 2))  # in-doubt resend
        client2.commit(_params(1.0), commit_id=(0, 3))
        assert _wait(lambda: a2.promoted)
        np.testing.assert_array_equal(a2.ps.get_params()["w"], 4.0)
        assert a2.ps.num_updates == 4
        assert a2.ps.num_duplicates == 1
        assert a2.ps._seen_seq == {0: 3}
        client2.close()
    finally:
        client.close()
        a2.stop()


def test_dynsgd_version_counter_survives_promotion():
    """DynSGD's staleness books are commit-identical on the promoted
    standby: the version counter continues, and a stale tag is scaled by
    the same 1/(staleness+1) the dead primary would have used."""
    primary, standby = _pair(DynSGDParameterServer)
    client = _client(primary, standby, retry=_policy())
    try:
        _, tag0 = client.pull(worker_id=0)
        assert tag0 == 0
        client.commit(_params(3.0), tag=tag0, commit_id=(0, 0))  # full
        client.commit(_params(3.0), tag=tag0, commit_id=(0, 1))  # /2
        primary.kill()
        assert _wait(lambda: standby.promoted)
        _, tag = client.pull(worker_id=0)
        assert tag == 2  # the version counter survived
        client.commit(_params(3.0), tag=tag0, commit_id=(0, 2))  # /3
        np.testing.assert_array_equal(standby.ps.get_params()["w"],
                                      np.float32(3.0 + 1.5 + 1.0))
        assert standby.ps._meta["version"] == 3
    finally:
        client.close()
        standby.stop()


def test_standby_does_not_promote_when_primary_answers_garbage():
    """Split-brain guard: a re-attach that fails for a NON-connection
    reason (a snapshot that does not decode) proves the primary alive —
    the standby stands down and never promotes."""
    primary, standby = _pair()
    client = _client(primary)
    try:
        client.commit(_params(1.0), commit_id=(0, 0))

        def corrupt_attach():
            raise ValueError("snapshot failed to decode")

        standby._attach_to_primary = corrupt_attach
        # break the stream from the primary's side (a FIN wakes the
        # follower's recv): every re-attach now decodes garbage
        primary.ps._replicas[0].close()
        assert _wait(lambda: not standby._repl_thread.is_alive())
        assert not standby.promoted
        assert standby.role == "standby"
        assert standby.last_postmortem["reason"] == "stand_down"
        # the primary keeps serving (sink detached, no gate armed)
        client.commit(_params(1.0), commit_id=(0, 1))
        np.testing.assert_array_equal(primary.ps.get_params()["w"], 2.0)
    finally:
        client.close()
        standby.stop()
        primary.stop()


def test_client_pinned_on_standby_rotates_to_healthy_primary():
    """A standby ANSWERS the dial, so a standby refusal must rotate the
    redial past the sticky index, or the client livelocks against a
    replica that never promotes (its primary is healthy)."""
    primary, standby = _pair()
    client = _client(standby, primary, retry=_policy(max_attempts=5))
    try:
        assert client.endpoint == ("127.0.0.1", standby.port)
        center, _ = client.pull(worker_id=0)  # refused once, then rotated
        np.testing.assert_array_equal(center["w"], 0.0)
        assert client.endpoint == ("127.0.0.1", primary.port)
        client.commit(_params(1.0), commit_id=(0, 0))
        np.testing.assert_array_equal(primary.ps.get_params()["w"], 1.0)
    finally:
        client.close()
        standby.stop()
        primary.stop()


def test_durability_gate_refuses_acks_without_replica():
    """require_replicas(1): a commit landing during a replication outage
    is never acked; the policy-paced resend is absorbed once the standby
    re-attaches (deduped: the apply already landed), and the promoted
    sole survivor relaxes the gate."""
    primary, standby = _pair()
    primary.ps.require_replicas(1)
    standby.ps.require_replicas(1)
    client = _client(primary, standby, retry=_policy())
    try:
        client.commit(_params(1.0), commit_id=(0, 0))  # replicated + acked
        plan = faults.FaultPlan(seed=0).arm("ps.replicate")
        with plan:
            # first attempt: replication lost mid-commit, no ack; the
            # resend is gated until the standby re-attaches, then deduped
            client.commit(_params(1.0), commit_id=(0, 1))
        assert _wait(lambda: standby.reattaches >= 1)
        np.testing.assert_array_equal(standby.ps.get_params()["w"], 2.0)
        assert standby.ps._seen_seq == {0: 1}
        assert primary.ps.min_replicas == 1  # re-armed by the re-attach
        refused = {s["name"]: s["value"]
                   for s in primary.ps.metrics_snapshot()
                   if s["kind"] == "counter"}
        assert refused["training_ps_commits_refused_no_replica"] >= 1
        # a gate refusal is typed and retriable
        primary.ps._replicas.clear()
        with pytest.raises(ParameterServerError, match="no_replica"):
            primary.ps.commit(_params(1.0), commit_id=(0, 9))
        primary.ps.attach_replica(_NullSink())
        # promotion relaxes the sole survivor's gate: it serves
        primary.kill()
        client.commit(_params(1.0), commit_id=(0, 2))
        assert _wait(lambda: standby.promoted)
        assert standby.ps.min_replicas == 0
        np.testing.assert_array_equal(standby.ps.get_params()["w"], 3.0)
    finally:
        client.close()
        standby.stop()


class _NullSink:
    def replicate(self, payload):
        raise ConnectionError("gone")

    def close(self):
        pass


def test_replication_fault_detaches_sink_and_standby_resyncs():
    """An armed ps.replicate seam breaks the stream: the primary detaches
    the sink and keeps serving; the standby re-attaches with a FRESH
    snapshot (never a gapped log) and is consistent again."""
    primary, standby = _pair()
    client = _client(primary)
    try:
        plan = faults.FaultPlan(seed=0).arm("ps.replicate")
        with plan:
            client.commit(_params(1.0), commit_id=(0, 0))
        assert plan.fired("ps.replicate") == 1
        assert primary.ps.replication_drops == 1
        np.testing.assert_array_equal(primary.ps.get_params()["w"], 1.0)
        assert _wait(lambda: standby.reattaches == 1)
        assert not standby.promoted  # the primary is alive: re-sync
        client.commit(_params(1.0), commit_id=(0, 1))
        np.testing.assert_array_equal(standby.ps.get_params()["w"], 2.0)
        assert standby.ps._seen_seq == {0: 1}
        kinds = [e["kind"] for e in primary.ps.recorder.snapshot()]
        assert "ps.detach" in kinds and kinds.count("ps.attach") == 2
    finally:
        client.close()
        standby.stop()
        primary.stop()


def test_promotion_writes_a_postmortem_naming_the_armed_seams(tmp_path):
    """A promotion dumps one bundle before serving: the standby's ring
    (sync, the replicated commits, the promotion), its metrics, the
    worker-activity table and the armed ``ps.*`` seams of the active
    plan, with their fire counts."""
    primary, standby = _pair(postmortem_dir=str(tmp_path))
    promoted = []
    standby.on_promote = promoted.append
    client = _client(primary, standby, retry=_policy())
    plan = (faults.FaultPlan(seed=0)
            .arm("ps.pull", action="delay", delay=0.0, times=None)
            .arm("ps.replicate", after=1000))
    try:
        with plan:
            client.pull(worker_id=4)
            client.commit(_params(1.0), commit_id=(4, 0))
            primary.kill()
            client.commit(_params(1.0), commit_id=(4, 1))
            # on_promote fires last, after the bundle is written
            assert _wait(lambda: promoted)
        assert promoted == [standby] and standby.promoted
        bundle, path = latest_postmortem(str(tmp_path))
        assert path == standby.last_postmortem_path
        assert bundle["component"] == "parameter_server"
        assert bundle["reason"] == "promotion"
        assert bundle["detail"] == {"reason": "primary-lost"}
        assert bundle["config"]["role"] == "primary"
        seams = {s["site"]: s for s in bundle["fault_seams"]}
        assert set(seams) == {"ps.pull", "ps.replicate"}
        assert seams["ps.pull"]["fired"] >= 1
        kinds = [e["kind"] for e in bundle["events"]]
        assert kinds[0] == "ps.sync" and kinds[-1] == "ps.promoted"
        assert {"worker_id": 4, "last_seq": 0} == {
            k: bundle["in_flight"][0][k] for k in ("worker_id", "last_seq")}
        names = {s["name"] for s in bundle["metrics"]}
        assert "training_ps_socket_promoted" in names
        with open(path) as f:
            assert json.load(f) == bundle
        np.testing.assert_array_equal(standby.ps.get_params()["w"], 2.0)
    finally:
        client.close()
        standby.stop()
