"""The port's ``networking`` (a copy of the JAX package's) against the JAX
package on the CPU, over loopback sockets only.

The wire is the thing under test: frames are an 8-byte big-endian length
prefix and the payload, byte for byte what the JAX ``send_data`` writes,
so each package's ``recv_data`` reads the other's frames. ``RetryPolicy``
draws its jitter from ``random.Random(seed)`` in both, so a seeded policy
replays the same sleep schedule (compared exactly). Every socket binds
``127.0.0.1:0`` and every wait is bounded.
"""

import socket
import struct
import threading
import time

import pytest

from distkeras_tpu import faults as jfaults
from distkeras_tpu import networking as jnet
from distkeras_tpu_torch import faults, networking


def _dead_port():
    """A loopback port nothing listens on (bound, then closed)."""
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _listener():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    s.listen(8)
    return s, s.getsockname()[1]


@pytest.fixture
def pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    yield a, b
    a.close()
    b.close()


@pytest.mark.parametrize("size", [0, 1, 4097, 3 << 20],
                         ids=["empty", "byte", "page", "3MiB"])
def test_frames_round_trip(pair, size):
    """A payload of any size arrives whole, prefixed by its length."""
    a, b = pair
    payload = bytes(range(256)) * (size // 256) + bytes(size % 256)
    t = threading.Thread(target=networking.send_data, args=(a, payload))
    t.start()
    assert networking.recv_data(b) == payload
    t.join(timeout=5)
    assert not t.is_alive()


def test_frame_bytes_are_the_jax_packages(pair):
    """The bytes on the wire: the same 8-byte big-endian prefix as the JAX
    encoder writes."""
    a, b = pair
    networking.send_data(a, b"hello")
    raw = b.recv(64)
    assert raw == struct.pack(">Q", 5) + b"hello"
    jnet.send_data(a, b"hello")
    assert b.recv(64) == raw


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_cross_implementation_frames(pair, direction):
    """A frame one package sends arrives through the other's
    ``recv_data``, back to back with the next one (no framing drift)."""
    a, b = pair
    send, recv = ((jnet.send_data, networking.recv_data)
                  if direction == "jax_to_port"
                  else (networking.send_data, jnet.recv_data))
    frames = [b"x" * n for n in (0, 7, 70000)]
    t = threading.Thread(target=lambda: [send(a, f) for f in frames])
    t.start()
    assert [recv(b) for _ in frames] == frames
    t.join(timeout=5)
    assert not t.is_alive()


def test_max_len_refuses_before_buffering(pair):
    a, b = pair
    a.sendall(struct.pack(">Q", 1 << 40))  # declared, never delivered
    with pytest.raises(ValueError, match="exceeds the 1024-byte limit"):
        networking.recv_data(b, max_len=1024)
    networking.send_data(a, b"y" * 1024)
    assert networking.recv_data(b, max_len=1024) == b"y" * 1024


def test_truncated_frame_is_a_connection_error(pair):
    a, b = pair
    a.sendall(struct.pack(">Q", 10) + b"abc")
    a.close()
    with pytest.raises(ConnectionError, match="mid-message"):
        networking.recv_data(b)


def test_connect_any_rotates_past_dead_endpoints():
    lst, port = _listener()
    dead = _dead_port()
    try:
        eps = [("127.0.0.1", dead), ("127.0.0.1", port)]
        sock, i = networking.connect_any(eps, timeout=2.0)
        assert i == 1
        assert sock.getsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY)
        sock.close()
        # sticky start: the live endpoint first, no rotation needed
        sock, i = networking.connect_any(eps, timeout=2.0, start=1)
        assert i == 1
        sock.close()
        # start wraps around the list
        sock, i = networking.connect_any(eps, timeout=2.0, start=2)
        assert i == 1
        sock.close()
    finally:
        lst.close()


def test_connect_any_names_every_endpoint_when_all_refuse():
    eps = [("127.0.0.1", _dead_port()), ("127.0.0.1", _dead_port())]
    with pytest.raises(networking.EndpointsUnreachableError) as ei:
        networking.connect_any(eps, timeout=2.0)
    assert [ep for ep, _ in ei.value.causes] == eps
    for host, port in eps:
        assert f"{host}:{port}" in str(ei.value)
    assert isinstance(ei.value, ConnectionError)
    with pytest.raises(ValueError):
        networking.connect_any([])


def test_probe_reports_each_endpoint():
    lst, port = _listener()
    dead = _dead_port()
    try:
        out = networking.probe([("127.0.0.1", port), ("127.0.0.1", dead)],
                               timeout=2.0)
        assert out[("127.0.0.1", port)] is None
        assert isinstance(out[("127.0.0.1", dead)], OSError)
        assert out.keys() == jnet.probe(
            [("127.0.0.1", port), ("127.0.0.1", dead)], timeout=2.0).keys()
    finally:
        lst.close()


@pytest.mark.parametrize("seed", [0, 7, 12345])
def test_retry_policy_draws_jax_delays(seed):
    """The same seed draws the same full-jitter schedule as the JAX
    package's policy, hints included (exact floats)."""
    kw = dict(max_attempts=9, base_delay=0.05, max_delay=0.4, seed=seed)
    mine, theirs = networking.RetryPolicy(**kw), jnet.RetryPolicy(**kw)
    hints = [None, None, 0.3, None, 5.0, None, -1.0, None, None, None]
    got = [mine.delay(a, hint=h) for a, h in enumerate(hints)]
    want = [theirs.delay(a, hint=h) for a, h in enumerate(hints)]
    assert got == want
    assert got[2] == 0.3 and got[4] == 0.4 and got[6] == 0.0
    assert all(0.0 <= d <= 0.4 for d in got)


def test_retry_policy_call_attempts_and_budget():
    calls = []

    def flaky():
        calls.append(time.monotonic())
        if len(calls) < 3:
            raise ConnectionResetError("down")
        return "up"

    seen = []
    pol = networking.RetryPolicy(max_attempts=5, base_delay=0.001,
                                 max_delay=0.01, seed=0)
    assert pol.call(flaky, on_retry=lambda e, a, d: seen.append(a)) == "up"
    assert len(calls) == 3 and seen == [1, 2]
    # the attempt cap re-raises the last failure unchanged
    def always(exc):
        def fn():
            calls.append(1)
            raise exc
        return fn

    calls.clear()
    pol = networking.RetryPolicy(max_attempts=2, base_delay=0.001, seed=0)
    with pytest.raises(ConnectionResetError):
        pol.call(always(ConnectionResetError("always")))
    assert len(calls) == 2
    # a zero budget refuses the first sleep that would overrun it
    pol = networking.RetryPolicy(max_attempts=50, base_delay=0.2,
                                 max_delay=0.2, budget=0.0, seed=1)
    calls.clear()
    with pytest.raises(OSError):
        pol.call(always(OSError("refused")))
    assert len(calls) == 1
    # a non-listed exception is not retried
    calls.clear()
    with pytest.raises(KeyError):
        networking.RetryPolicy(seed=0).call(always(KeyError("x")))
    assert len(calls) == 1
    with pytest.raises(ValueError):
        networking.RetryPolicy(max_attempts=0)


@pytest.mark.parametrize("action", ["corrupt", "truncate", "reset"])
def test_injected_send_faults_match_jax(action):
    """An armed ``net.send`` seam breaks the frame the same way in both
    packages: ``corrupt`` flips the middle byte and sends normally,
    ``truncate``/``reset`` deliver half the declared frame and raise (an
    RST may discard what the peer had not read yet, so ``reset``'s bytes
    are compared only as a prefix)."""
    payload = bytes(range(64))
    got = {}
    for name, net, fl in (("port", networking, faults),
                          ("jax", jnet, jfaults)):
        a, b = socket.socketpair()
        b.settimeout(5.0)
        plan = fl.FaultPlan(seed=0).arm("net.send", action=action)
        try:
            with plan:
                if action == "corrupt":
                    net.send_data(a, payload)
                else:
                    with pytest.raises(ConnectionResetError,
                                       match=f"injected net.send fault: "
                                             f"{action}"):
                        net.send_data(a, payload)
            data = b""
            while True:
                try:
                    chunk = b.recv(4096)
                except ConnectionResetError:
                    break
                if not chunk or len(data) + len(chunk) >= 8 + 64:
                    data += chunk
                    break
                data += chunk
            got[name] = data
            assert plan.fired("net.send") == 1
        finally:
            a.close()
            b.close()
    frame = struct.pack(">Q", 64) + payload
    if action == "corrupt":
        assert got["port"] == got["jax"]
        assert got["port"][8 + 32] == payload[32] ^ 0xFF
        assert got["port"][:8 + 32] == frame[:8 + 32]
    elif action == "truncate":
        assert got["port"] == got["jax"] == frame[:8 + 32]
    else:
        for data in got.values():
            assert frame[:8 + 32].startswith(data)
