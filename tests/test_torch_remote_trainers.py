"""The port's async trainers over the socket tier on the CPU:
``remote_ps=True`` (workers reach the PS through
``RemoteParameterServerClient`` over loopback), ``serve_socket`` and
``standby`` (a warm standby that promotes when the primary is killed).

In simulated mode the seeded schedule fixes every pull and commit, and
the wire carries f32 npz losslessly, so a ``remote_ps`` run is bit for
bit the in-process run; against the JAX package's own ``remote_ps`` run
the bars are ``test_trainer_matches_jax_simulated``'s (losses 1e-5
relative, weights 1e-5 absolute: only the matmul summation order
differs). The failover runs use threads: their commit ledgers (update
count, every worker's last commit seq, no duplicate lost or doubled)
must equal the unfaulted run's."""

import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from distkeras_tpu import ADAG as JADAG
from distkeras_tpu import AEASGD as JAEASGD
from distkeras_tpu import DOWNPOUR as JDOWNPOUR
from distkeras_tpu import DynSGD as JDynSGD
from distkeras_tpu_torch import ADAG, AEASGD, DOWNPOUR, DynSGD
from distkeras_tpu_torch.parameter_servers import RemoteParameterServerClient
from distkeras_tpu_torch.utils.checkpoint import Checkpointer

sys.path.insert(0, str(Path(__file__).parent))
from test_torch_async import ASYNC, _jax_data, _mlps, _port_data  # noqa: E402


@pytest.fixture(autouse=True)
def _uncached_jax_cores(monkeypatch):
    """Uncached JAX worker cores (as ``test_torch_async.py``): a cached
    core from another test's optimizer must not be handed to these."""
    monkeypatch.setenv("DKT_DISABLE_CORE_CACHE", "1")


def _center_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("port_cls,jax_cls", [
    (DOWNPOUR, JDOWNPOUR), (AEASGD, JAEASGD), (ADAG, JADAG),
    (DynSGD, JDynSGD)], ids=["DOWNPOUR", "AEASGD", "ADAG", "DynSGD"])
def test_remote_ps_simulated_is_the_inprocess_run_and_jaxs(port_cls, jax_cls):
    """``remote_ps=True`` in simulated mode: the port's center and every
    step's loss bit-identical to its in-process run (the socket neither
    reorders nor re-encodes), and within the JAX parity bars of the JAX
    package's ``remote_ps`` run."""
    jm, tm = _mlps()
    opt = "sgd" if port_cls is AEASGD else "pallas_sgd"
    local = port_cls(tm, opt, device="cpu", **ASYNC)
    local_res = local.train(_port_data())
    remote = port_cls(tm, opt, device="cpu", remote_ps=True, **ASYNC)
    remote_res = remote.train(_port_data())
    assert remote.serve_socket and remote.service is None  # stopped
    _center_equal(remote.parameter_server.get_params(),
                  local.parameter_server.get_params())
    assert ([r["loss"] for r in remote.get_history()]
            == [r["loss"] for r in local.get_history()])
    for a, b in zip(remote_res.get_weights(), local_res.get_weights()):
        np.testing.assert_array_equal(a, b)
    ps = remote.parameter_server
    assert ps.num_updates == 8 and ps.num_duplicates == 0
    assert remote.failures == [] and remote.ps_failovers == 0
    assert all(isinstance(w.ps, RemoteParameterServerClient)
               for w in remote.workers)
    assert [w.ps_failovers for w in remote.workers] == [0] * 4
    # the PS's books saw the socket traffic
    counts = {s["name"]: s["value"] for s in ps.metrics_snapshot()
              if s["kind"] == "counter"}
    assert counts["training_ps_commits"] == 8
    assert counts["training_ps_pulls"] == 8
    jt = jax_cls(jm, "sgd" if port_cls is AEASGD else "pallas_sgd",
                 remote_ps=True, **ASYNC)
    jres = jt.train(_jax_data())
    for a, b in zip(jt.get_history(), remote.get_history()):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for a, b in zip(remote_res.get_weights(), jres.get_weights()):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    assert jt.parameter_server.num_updates == 8


def test_compressed_commits_and_pulls_over_the_socket(monkeypatch):
    """``compress="int8"`` + ``pull_compress="bfloat16"`` over the socket:
    int8 codes and bf16 payloads cross with their dtypes, and the run is
    bit for bit the in-process compressed run."""
    _, tm = _mlps()
    kw = dict(ASYNC, compress="int8", pull_compress="bfloat16")
    local = DOWNPOUR(tm, "pallas_sgd", device="cpu", **kw)
    local.train(_port_data())
    seen = []
    remote = DOWNPOUR(tm, "pallas_sgd", device="cpu", remote_ps=True, **kw)
    commit = RemoteParameterServerClient.commit

    def spy(self, delta, *a, **k):
        seen.append({k2: v.dtype for k2, v in
                     delta["__dkt_q8__"]["q"].items()})
        return commit(self, delta, *a, **k)

    monkeypatch.setattr(RemoteParameterServerClient, "commit", spy)
    remote.train(_port_data())
    assert len(seen) == 8
    assert all(set(d.values()) == {np.dtype(np.int8)} for d in seen)
    _center_equal(remote.parameter_server.get_params(),
                  local.parameter_server.get_params())
    losses = [r["loss"] for r in remote.get_history()]
    assert losses == [r["loss"] for r in local.get_history()]
    assert np.isfinite(losses).all()


def test_serve_socket_and_inprocess_standby_replicate():
    """In-process workers with ``standby=True`` (implies
    ``serve_socket``): the run equals the plain one bit for bit, and at
    the end the standby — which follows but never promotes here — holds
    the primary's center, dedup table and update count."""
    _, tm = _mlps()
    plain = DOWNPOUR(tm, "pallas_sgd", device="cpu", **ASYNC)
    plain.train(_port_data())
    t = DOWNPOUR(tm, "pallas_sgd", device="cpu", standby=True, **ASYNC)
    assert t.serve_socket and not t.remote_ps
    seen = {}
    stop = t.stop_service

    def capture():
        seen["standby"] = t.standby_service.ps.snapshot()
        seen["primary"] = t.parameter_server.snapshot()
        seen["auto_promote"] = t.standby_service.auto_promote
        client = RemoteParameterServerClient("127.0.0.1",
                                             t.standby_service.port)
        seen["scrape"] = client.metrics()
        client.close()
        stop()

    t.stop_service = capture
    t.train(_port_data())
    _center_equal(t.parameter_server.get_params(),
                  plain.parameter_server.get_params())
    (sc, sm), (pc, pm) = seen["standby"], seen["primary"]
    _center_equal(sc, pc)
    assert sm == pm and pm["num_updates"] == 8
    assert seen["auto_promote"] is False and t.ps_promotions == []
    assert seen["scrape"]["role"] == "standby"


def _failover_run(tmp_path=None, kill_at=None, num_epoch=1, resume=False,
                  n=1024):
    """AEASGD, 4 worker threads, remote PS + warm standby, worker_retries
    2; ``kill_at``: kill the primary once it has applied that many
    commits. Returns the trainer and the seconds from kill to promotion."""
    _, tm = _mlps()
    kw = dict(ASYNC, num_epoch=num_epoch, mode="threads",
              communication_window=2)
    if tmp_path is not None:
        kw.update(checkpoint_dir=str(tmp_path), checkpoint_every=4)
    t = AEASGD(tm, "pallas_sgd", device="cpu", remote_ps=True, standby=True,
               worker_retries=2, **kw)
    killed = {}

    def killer():
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and "done" not in killed:
            svc = t.service
            if (svc is not None and not svc.killed
                    and t.parameter_server.num_updates >= kill_at):
                # stamped before the call: the standby may promote
                # before kill() returns
                killed["t"] = time.monotonic()
                svc.kill()
                return
            time.sleep(0.001)

    th = None
    if kill_at is not None:
        th = threading.Thread(target=killer, daemon=True)
        th.start()
    try:
        t.train(_port_data(n), resume=resume)
    finally:
        killed["done"] = True
        if th is not None:
            th.join(timeout=5)
    assert th is None or not th.is_alive()
    return t, killed


def _ledger(t):
    ps = t.active_parameter_server()
    return ps.num_updates, dict(ps._seen_seq)


def test_killed_primary_promotes_standby_with_an_equal_ledger():
    """The primary killed at half the expected commits: the run finishes,
    exactly one promotion (``primary-lost``), at least one client
    failover, and the promoted standby's commit ledger — update count and
    every worker's final seq — equals the unfaulted run's."""
    clean, _ = _failover_run()
    assert clean.failures == [] and clean.ps_promotions == []
    assert _ledger(clean) == (16, {0: 3, 1: 3, 2: 3, 3: 3})
    t, killed = _failover_run(kill_at=8)
    assert "t" in killed, "the primary was never killed"
    assert _ledger(t) == _ledger(clean)
    assert len(t.ps_promotions) == 1
    assert t.ps_promotions[0]["reason"] == "primary-lost"
    assert t.ps_failovers >= 1
    assert sum(w.ps_failovers for w in t.workers) == t.ps_failovers
    sb = t.standby_service
    assert sb.promoted and sb.last_postmortem["reason"] == "promotion"
    assert 0 <= sb.promoted_at - killed["t"] < 5.0
    center = t.active_parameter_server().get_params()
    assert all(np.isfinite(v).all() for v in center.values())
    # the run's result is the promoted standby's center
    assert t.active_parameter_server() is sb.ps


def test_checkpoint_after_promotion_restores(tmp_path):
    """Checkpointing re-attaches to the promoted standby: the final
    checkpoint holds the survivor's center and dedup table, and a resume
    from it runs the second epoch to exactly twice the commits."""
    t, killed = _failover_run(tmp_path, kill_at=8)
    assert "t" in killed and len(t.ps_promotions) == 1
    ck = Checkpointer(str(tmp_path))
    step, trees, meta = ck.restore()
    assert step == 16
    _center_equal(trees["center"], t.active_parameter_server().get_params())
    assert meta["ps_meta"]["seen_seq"] == {str(w): 3 for w in range(4)}
    assert len(trees["workers"]) == 4
    # periodic snapshots kept coming after the promotion
    assert set(ck.all_steps()) >= {12, 16}
    resumed, _ = _failover_run(tmp_path, num_epoch=2, resume=True)
    assert resumed.failures == []
    assert _ledger(resumed) == (32, {w: 7 for w in range(4)})
    # no new duplicate: the count is the restored one (the faulted run's
    # in-doubt resends)
    assert (resumed.parameter_server.num_duplicates
            == meta["ps_meta"].get("num_duplicates", 0))


def test_worker_retry_redials_a_remote_ps():
    """``reset_for_retry`` redials a remote PS (a crashed stream may be
    desynced), under the given policy, and an in-process PS is left
    alone; the worker's failover count is its client's."""
    from distkeras_tpu_torch.networking import RetryPolicy
    from distkeras_tpu_torch.ops.optimizers import get_optimizer
    from distkeras_tpu_torch.workers import DOWNPOURWorker, WorkerCore

    class FlakyClient:
        failovers = 2

        def __init__(self):
            self.calls = 0

        def reconnect(self):
            self.calls += 1
            if self.calls == 1:
                raise ConnectionRefusedError("primary restarting")

    _, tm = _mlps()
    core = WorkerCore(tm, get_optimizer("sgd", 0.02),
                      "categorical_crossentropy")
    client = FlakyClient()
    w = DOWNPOURWorker(core, client, 0, "features", "label_onehot", 2,
                       device="cpu")
    w._seq = 5
    w.reset_for_retry(retry=RetryPolicy(max_attempts=3, base_delay=0.001,
                                        seed=0))
    assert client.calls == 2 and w._seq == 0
    assert w.ps_failovers == 2
    with pytest.raises(ConnectionRefusedError):
        client.calls = 0
        w.reset_for_retry()  # no policy: the first refusal surfaces
    local = DOWNPOURWorker(core, object(), 1, "features", "label_onehot", 2,
                           device="cpu")
    local.reset_for_retry()
    assert local.ps_failovers == 0
