"""The port's socket parameter-server tier (``SocketParameterServer``,
``RemoteParameterServerClient``) on the CPU: the port counterparts of the
JAX package's socket tests, and the two packages' tiers talking to each
other over loopback.

The wire is the DKT1 frame (JSON header + npz) over length-prefixed
frames in both packages, so the cross-implementation runs compare
exactly: the same commits, raw or compressed, leave bit-equal centers on
a port server fed by a JAX client, on a JAX server fed by a port client,
and on an in-process port PS. Every socket binds ``127.0.0.1:0``, every
thread is joined with a timeout, every retry budget is bounded.
"""

import socket
import threading
import time

import numpy as np
import pytest

from distkeras_tpu import parameter_servers as jps
from distkeras_tpu_torch import faults, networking
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.utils.compression import (
    maybe_decode_pull,
    quantize_tree,
    topk_compress,
)
from distkeras_tpu_torch.utils.serialization import pack_frame, unpack_frame

PARAMS = {"w": np.zeros(3, np.float32)}
DELTA = {"w": np.ones(3, np.float32)}


def _params(v=0.0):
    return {"w": np.full((3,), v, np.float32)}


def _wait(cond, timeout=5.0, step=0.02):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(step)
    return False


def _policy(**kw):
    kw.setdefault("max_attempts", 20)
    kw.setdefault("base_delay", 0.02)
    kw.setdefault("max_delay", 0.2)
    kw.setdefault("budget", 2.0)
    kw.setdefault("seed", 0)
    return networking.RetryPolicy(**kw)


def _server(ps):
    srv = tps.SocketParameterServer(ps, host="127.0.0.1")
    srv.start()
    return srv


# --------------------------------------------- counterparts of JAX's tests


def test_socket_ps_roundtrip():
    srv = _server(tps.DynSGDParameterServer(_params(0.0)))
    try:
        client = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
        center, tag = client.pull()
        assert tag == 0
        np.testing.assert_array_equal(center["w"], 0.0)
        client.commit(_params(2.0), tag=tag)
        center2, tag2 = client.pull()
        assert tag2 == 1
        np.testing.assert_array_equal(center2["w"], 2.0)
        client.close()
    finally:
        srv.stop()


def test_socket_ps_concurrent_clients():
    ps = tps.DeltaParameterServer(_params(0.0))
    srv = _server(ps)
    try:
        def client_run():
            c = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
            for _ in range(10):
                c.commit(_params(1.0))
            c.close()

        threads = [threading.Thread(target=client_run) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=10)
        assert not any(t.is_alive() for t in threads)
        np.testing.assert_array_equal(ps.get_params()["w"], 40.0)
        assert ps.num_updates == 40
    finally:
        srv.stop()


def test_socket_server_survives_client_disconnects():
    ps = tps.DeltaParameterServer(PARAMS)
    srv = _server(ps)
    try:
        # half a commit, then vanish
        sock = networking.connect("127.0.0.1", srv.port)
        sock.sendall(b"c")
        sock.close()
        # garbage action byte
        sock = networking.connect("127.0.0.1", srv.port)
        sock.sendall(b"z")
        sock.close()
        time.sleep(0.1)
        # the server still serves a well-behaved client, dedup intact
        client = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
        center, _ = client.pull()
        np.testing.assert_array_equal(center["w"], np.zeros(3))
        client.commit(DELTA, commit_id=(7, 0))
        client.commit(DELTA, commit_id=(7, 0))
        client.close()
        assert ps.num_updates == 1
        assert ps.num_duplicates == 1
    finally:
        srv.stop()


def test_socket_pull_registers_heartbeat():
    """A remote worker that pulls and dies before committing is still
    visible to the failure detector."""
    ps = tps.DeltaParameterServer(PARAMS)
    srv = _server(ps)
    try:
        client = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
        client.pull(worker_id=5)
        client.close()
        time.sleep(0.05)
        assert ps.suspected_failures(timeout=0.01) == [5]
    finally:
        srv.stop()


def test_unknown_action_gets_typed_error_and_close():
    srv = _server(tps.DeltaParameterServer(_params()))
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.sendall(b"z")
        assert s.recv(1) == b"e"
        header, _ = unpack_frame(networking.recv_data(s))
        assert header["error"] == "unknown_action"
        assert header["action"] == "7a"
        assert s.recv(1) == b""  # the server closed the connection
        s.close()
    finally:
        srv.stop()


def test_garbage_bytes_do_not_poison_later_clients():
    srv = _server(tps.DeltaParameterServer(_params()))
    try:
        s = socket.create_connection(("127.0.0.1", srv.port), timeout=5)
        s.sendall(b"\x00\xffgarbage")
        s.recv(1)  # error status (then close)
        s.close()
        client = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
        client.commit(_params(1.0), commit_id=(0, 0))
        center, _ = client.pull()
        np.testing.assert_array_equal(center["w"], 1.0)
        client.close()
    finally:
        srv.stop()


def test_conn_threads_reaped_and_joined_on_stop():
    srv = _server(tps.DeltaParameterServer(_params()))
    try:
        for _ in range(15):
            c = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
            c.pull()
            c.close()
        # one live keep-alive connection forces a reap pass on its accept
        keep = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
        keep.pull()
        assert _wait(lambda: len(srv._conn_threads) <= 3), (
            f"{len(srv._conn_threads)} conn threads still tracked")
        keep.close()
    finally:
        srv.stop()
    assert all(not t.is_alive() for t in srv._conn_threads)


def test_commit_not_acknowledged_carries_commit_id():
    listener = socket.socket()
    listener.bind(("127.0.0.1", 0))
    listener.listen(1)
    listener.settimeout(5)
    port = listener.getsockname()[1]

    def bad_server():
        conn, _ = listener.accept()
        conn.recv(1)  # action
        networking.recv_data(conn)  # commit frame
        conn.sendall(b"x")  # not a valid status byte
        conn.close()

    t = threading.Thread(target=bad_server, daemon=True)
    t.start()
    client = tps.RemoteParameterServerClient("127.0.0.1", port)
    with pytest.raises(tps.CommitNotAcknowledgedError) as ei:
        client.commit(_params(1.0), commit_id=(3, 7))
    assert ei.value.commit_id == (3, 7)
    assert ei.value.code == "commit_not_acknowledged"
    assert not ei.value.stream_in_sync
    client.close()
    listener.close()
    t.join(timeout=5)
    assert not t.is_alive()


def test_pull_and_commit_reconnect_and_retry_when_stream_dies():
    srv = _server(tps.DeltaParameterServer(_params()))
    try:
        client = tps.RemoteParameterServerClient("127.0.0.1", srv.port,
                                                 retry=_policy())
        client._sock.close()  # the stream died under us
        center, _ = client.pull()
        np.testing.assert_array_equal(center["w"], 0.0)
        client._sock.close()
        client.commit(_params(1.0), commit_id=(0, 0))
        np.testing.assert_array_equal(srv.ps.get_params()["w"], 1.0)
        # an id-less commit cannot be safely resent: it surfaces instead
        client._sock.close()
        with pytest.raises((ConnectionError, OSError)):
            client.commit(_params(1.0))
        np.testing.assert_array_equal(srv.ps.get_params()["w"], 1.0)
        client.close()
    finally:
        srv.stop()


def test_injected_commit_fault_on_socket_is_typed_and_resent():
    """An armed ps.commit seam on the socket path is a typed ``internal``
    reply (the stream stays in sync) and the policy retry resends it —
    exactly once."""
    srv = _server(tps.DeltaParameterServer(_params()))
    try:
        client = tps.RemoteParameterServerClient("127.0.0.1", srv.port,
                                                 retry=_policy())
        plan = faults.FaultPlan(seed=0).arm("ps.commit")
        with plan:
            client.commit(_params(1.0), commit_id=(0, 0))
        assert plan.fired("ps.commit") == 1
        np.testing.assert_array_equal(srv.ps.get_params()["w"], 1.0)
        assert srv.ps.num_updates == 1
        # the firing is on the PS's recorder tape
        fired = srv.ps.recorder.events("fault.fired")
        assert [e["site"] for e in fired] == ["ps.commit"]
        client.close()
    finally:
        srv.stop()


def test_ps_seams_fire_on_inprocess_transport():
    ps = tps.DeltaParameterServer(_params())
    plan = faults.FaultPlan(seed=0).arm("ps.pull").arm("ps.commit")
    with plan:
        with pytest.raises(faults.InjectedFault):
            ps.pull(worker_id=0)
        ps.pull(worker_id=0)  # seam exhausted
        with pytest.raises(faults.InjectedFault):
            ps.commit(_params(1.0), commit_id=(0, 0))
        ps.commit(_params(1.0), commit_id=(0, 0))
    assert plan.fired("ps.pull") == 1 and plan.fired("ps.commit") == 1
    np.testing.assert_array_equal(ps.get_params()["w"], 1.0)
    assert ps.num_updates == 1


def test_socket_client_preserves_compressed_dtypes():
    """The client's host conversion keeps compact integer dtypes (int8
    codes, uint16 bf16 payloads, int32 top-k indices) through nested
    payload dicts, and normalizes floats to f32."""
    import torch

    tree = {"q": np.arange(8, dtype=np.int8),
            "u": np.arange(8, dtype=np.uint16),
            "i": np.arange(8, dtype=np.int32),
            "f64": np.ones(4, np.float64),
            "f32": np.ones(4, np.float32),
            "nested": {"t": torch.arange(4, dtype=torch.int32),
                       "h": torch.ones(2, dtype=torch.float16)}}
    out = tps._to_host(tree)
    assert out["q"].dtype == np.int8
    assert out["u"].dtype == np.uint16
    assert out["i"].dtype == np.int32
    assert out["f64"].dtype == np.float32
    assert out["f32"].dtype == np.float32
    assert out["nested"]["t"].dtype == np.int32
    assert out["nested"]["h"].dtype == np.float32
    out["q"][0] = 9
    assert tree["q"][0] == 0  # copies


def test_metrics_and_timeseries_actions():
    ps = tps.DeltaParameterServer(_params())
    srv = _server(ps)
    try:
        client = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
        for seq in range(3):
            client.pull(worker_id=1)
            client.commit(_params(1.0), commit_id=(1, seq))
        m = client.metrics()
        assert m["role"] == "primary" and m["port"] == srv.port
        by_name = {}
        for s in m["metrics"]:
            by_name.setdefault(s["name"], []).append(s)
        assert by_name["training_ps_pulls"][0]["value"] == 3
        assert by_name["training_ps_commits"][0]["value"] == 3
        assert by_name["training_ps_updates"][0]["value"] == 3
        hists = by_name["training_ps_commit_interval_seconds"]
        assert [h["labels"] for h in hists] == [{}, {"worker": "1"}]
        assert hists[0]["count"] == 2
        ts = client.timeseries(window=60.0, names=["training_ps_commits"],
                               points=5)
        assert ts["role"] == "primary"
        assert ts["timeseries"] == json_roundtrip(ts["timeseries"])
        client.close()
    finally:
        srv.stop()


def json_roundtrip(x):
    import json

    return json.loads(json.dumps(x))


# ------------------------------------------------- across implementations


def _center(seed=0):
    rng = np.random.default_rng(seed)
    return {"dense.kernel": rng.standard_normal((64, 33)).astype(np.float32),
            "dense.bias": rng.standard_normal(33).astype(np.float32),
            "norm.scale": rng.standard_normal(64).astype(np.float32)}


def _commits():
    """A raw f32 delta, an int8-quantized one and a top-k one (the wire
    payloads the workers' ``compress=`` modes send), each with a commit
    id, then a replayed id."""
    raw = _center(1)
    q8, _ = quantize_tree(_center(2))
    topk, _ = topk_compress(_center(3), 0.1)
    return [(raw, (0, 0)), (q8, (0, 1)), (topk, (1, 0)), (raw, (0, 1))]


@pytest.mark.parametrize("server_pkg", ["port", "jax"])
@pytest.mark.parametrize("ps_name", ["DeltaParameterServer",
                                     "DynSGDParameterServer"])
def test_cross_implementation_centers_bit_equal(server_pkg, ps_name):
    """A JAX client against a port server, and a port client against a
    JAX server: after the same pulls and commits (raw, int8, top-k, a
    replay; DynSGD with stale tags) the server's center is bit-equal to an
    in-process port PS fed the same payloads, the dedup and version books
    agree, and a bf16-compressed pull decodes to the same bits."""
    server_mod, client_mod = ((tps, jps) if server_pkg == "port"
                              else (jps, tps))
    ps = getattr(server_mod, ps_name)(_center(0))
    ref = getattr(tps, ps_name)(_center(0))
    srv = server_mod.SocketParameterServer(ps, host="127.0.0.1")
    srv.start()
    try:
        client = client_mod.RemoteParameterServerClient("127.0.0.1",
                                                        srv.port)
        for delta, cid in _commits():
            _, tag = client.pull(worker_id=cid[0])
            _, rtag = ref.pull(worker_id=cid[0])
            assert tag == rtag
            stale = None if tag is None else max(0, tag - 1)
            client.commit(delta, tag=stale, commit_id=cid)
            ref.commit(delta, stale, commit_id=cid)
        center, _ = client.pull()
        want = ref.get_params()
        assert center.keys() == want.keys()
        for k in want:
            assert center[k].dtype == np.float32
            np.testing.assert_array_equal(center[k], want[k])
        assert ps.num_updates == ref.num_updates == 3
        assert ps.num_duplicates == ref.num_duplicates == 1
        assert ps._seen_seq == ref._seen_seq == {0: 1, 1: 0}
        assert ps._meta.get("version") == ref._meta.get("version")
        # bf16 pulls: the encoded payload crosses with its uint16/int8
        # dtypes and decodes to the same bits as the in-process encode
        ps.pull_compress = ref.pull_compress = "bfloat16"
        wire, _ = client.pull()
        local, _ = ref.pull()
        for k in want:
            np.testing.assert_array_equal(maybe_decode_pull(wire)[k],
                                          maybe_decode_pull(local)[k])
        leaf = next(iter(wire.values()))["v"]["dense.bias"]
        assert leaf.dtype == np.uint16
        client.close()
    finally:
        srv.stop()


def test_metrics_action_sample_names_equal_across_packages():
    """The same traffic against a port server and a JAX server: ``m``
    scrapes carry the same sample names (and labels) on both sides, and
    the same counter values."""
    scrapes = {}
    for name, mod in (("port", tps), ("jax", jps)):
        srv = mod.SocketParameterServer(
            mod.DeltaParameterServer(_params()), host="127.0.0.1")
        srv.start()
        try:
            client = tps.RemoteParameterServerClient("127.0.0.1", srv.port)
            for seq in range(3):
                client.pull(worker_id=0)
                client.commit(_params(1.0), commit_id=(0, seq))
            scrapes[name] = client.metrics()
            client.close()
        finally:
            srv.stop()
    ids = {k: [(s["name"], s.get("labels", {})) for s in v["metrics"]]
           for k, v in scrapes.items()}
    assert ids["port"] == ids["jax"]
    counts = {k: {s["name"]: s["value"] for s in v["metrics"]
                  if s["kind"] == "counter"} for k, v in scrapes.items()}
    assert counts["port"] == counts["jax"]
    assert counts["port"]["training_ps_commits"] == 3


def test_standby_attach_across_packages():
    """A port standby follows a JAX primary (and the reverse): the
    attach snapshot and the replication stream are the same frames."""
    for primary_mod, standby_mod in ((jps, tps), (tps, jps)):
        primary = primary_mod.SocketParameterServer(
            primary_mod.DeltaParameterServer(_center(0)), host="127.0.0.1")
        primary.start()
        standby = standby_mod.SocketParameterServer(
            standby_mod.DeltaParameterServer(_center(0)), host="127.0.0.1",
            standby_of=("127.0.0.1", primary.port))
        try:
            client = tps.RemoteParameterServerClient("127.0.0.1",
                                                     primary.port)
            client.commit(_center(1), commit_id=(0, 0))
            standby.start()
            q8, _ = quantize_tree(_center(2))
            client.commit(q8, commit_id=(0, 1))
            a, b = primary.ps.get_params(), standby.ps.get_params()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
            assert standby.ps._seen_seq == {0: 1}
            client.close()
        finally:
            standby.stop()
            primary.stop()


def test_raw_frames_are_the_protocol():
    """The pull request and reply spoken by hand, byte for byte: action
    byte, a DKT1 frame, the status byte and a DKT1 reply frame."""
    srv = _server(tps.DynSGDParameterServer(_params(2.0)))
    try:
        s = networking.connect("127.0.0.1", srv.port, timeout=5)
        s.sendall(b"p")
        networking.send_data(s, pack_frame({"worker_id": 3}))
        assert s.recv(1) == b"k"
        header, blob = unpack_frame(networking.recv_data(s))
        assert header == {"tag": 0}
        assert jps.deserialize_params(blob)["w"].tolist() == [2.0] * 3
        s.sendall(b"s")  # stop verb
        assert _wait(lambda: not srv._running.is_set())
        s.close()
    finally:
        srv.stop()
