"""The DKTX transfer codec and the peer fabric in the port, against the JAX
package.

The JAX counterparts: ``tests/test_disagg.py`` (codec: ``:80-160``) and
``tests/test_fabric.py:285`` (the breaker-open skip). Here: the port's
``encode_state``/``encode_prefix`` give JAX's bytes for the same state in
f32, f16 and bf16 (JAX's ``ml_dtypes.bfloat16`` rows against the port's
uint16 bit rows); each side decodes the other's frames bit for bit;
truncated, corrupt, foreign-magic, future-version and ill-described frames
raise the typed ``KvTransferError``; a real stepper's swap state
round-trips; an open breaker skips a fetch without spending retry budget.
"""

from __future__ import annotations

import socket
import struct

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.serving import (
    KvTransferError,
    PeerError,
    PeerFabric,
    SamplingParams,
    ServingEngine,
    ServingError,
    decode_state,
    encode_state,
)
from distkeras_tpu_torch.serving import kv_transfer

torch.set_num_threads(2)

VOCAB = 61
DTYPES = ("float32", "float16", "bfloat16")


def _rows(dtn, shape, rng):
    """(port rows, JAX rows) of one K or V stage: the same bits, bf16 as
    uint16 in the port and ``ml_dtypes.bfloat16`` in JAX."""
    x = rng.standard_normal(shape).astype(np.float32)
    if dtn == "bfloat16":
        import ml_dtypes

        j = x.astype(ml_dtypes.bfloat16)
        return j.view(np.uint16), j
    a = x.astype(dtn)
    return a, a


def _states(dtn, stages=2, p=5, nh=2, hd=4, spec=False):
    """A swap-format state as the port and as JAX hold it."""
    rng = np.random.default_rng(0)
    ctx = rng.integers(0, VOCAB, p + 1).astype(np.int32)
    kv_port, kv_jax = [], []
    for _ in range(stages):
        kp, kj = _rows(dtn, (p, nh, hd), rng)
        vp, vj = _rows(dtn, (p, nh, hd), rng)
        kv_port.append((kp, vp))
        kv_jax.append((kj, vj))
    base = {"len": p + 1, "ctx": ctx, "spos": 3, "seed": 42,
            "spec_prompt": (np.arange(4, dtype=np.int32) if spec else None)}
    return dict(base, kv=kv_port), dict(base, kv=kv_jax)


def _bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


def _same_kv(a, b):
    assert len(a) == len(b)
    for (k0, v0), (k1, v1) in zip(a, b):
        assert np.array_equal(_bits(k0), _bits(k1))
        assert np.array_equal(_bits(v0), _bits(v1))


GRAMMAR = {"kind": "allow", "tokens": [1, 2, 3]}


@pytest.mark.parametrize("dtn", DTYPES)
@pytest.mark.parametrize("extra", ["plain", "sampled_epoch_spec"])
def test_encode_state_bytes_equal_jax(dtn, extra):
    """The port's frame is JAX's, byte for byte: magic, version, the JSON
    header (key order, ``"bfloat16"`` for uint16 rows, the crc, ``epoch``
    only when given) and the raw payload."""
    from distkeras_tpu.serving import kv_transfer as jkv
    from distkeras_tpu.serving.sampling import SamplingParams as JSampling

    spec = extra != "plain"
    mine, theirs = _states(dtn, spec=spec)
    kw = {}
    jkw = {}
    if spec:
        wire = {"temperature": 0.7, "top_p": 0.9, "seed": 11,
                "grammar": GRAMMAR}
        kw = dict(sampling=SamplingParams.from_wire(wire), eos_id=7,
                  epoch=0x1_2345_6789)
        jkw = dict(kw, sampling=JSampling.from_wire(wire))
    blob = encode_state(mine, prompt_len=4, **kw)
    assert blob == jkv.encode_state(theirs, prompt_len=4, **jkw)
    assert blob[:4] == b"DKTX"
    assert struct.unpack_from(">H", blob, 4)[0] == kv_transfer.VERSION == 1


@pytest.mark.parametrize("dtn", DTYPES)
def test_encode_prefix_bytes_equal_jax(dtn):
    from distkeras_tpu.serving import kv_transfer as jkv

    mine, theirs = _states(dtn, p=8)
    toks = np.arange(8, dtype=np.int32)
    assert (kv_transfer.encode_prefix(toks, mine["kv"], epoch=99)
            == jkv.encode_prefix(toks, theirs["kv"], epoch=99))


@pytest.mark.parametrize("dtn", DTYPES)
def test_frames_decode_across_implementations(dtn):
    """A JAX frame decodes in the port and a port frame in JAX, every
    field bit for bit; bf16 rows arrive as uint16 bits here and as
    ``ml_dtypes.bfloat16`` there."""
    from distkeras_tpu.serving import kv_transfer as jkv
    from distkeras_tpu.serving.sampling import SamplingParams as JSampling

    mine, theirs = _states(dtn, spec=True)
    wire = {"temperature": 0.8, "seed": 5, "grammar": GRAMMAR}
    jblob = jkv.encode_state(theirs, prompt_len=4,
                             sampling=JSampling.from_wire(wire), eos_id=3,
                             epoch=17)
    out = decode_state(jblob)
    want_dt = np.uint16 if dtn == "bfloat16" else np.dtype(dtn)
    assert out["kv"][0][0].dtype == want_dt
    _same_kv(out["kv"], mine["kv"])
    assert np.array_equal(out["ctx"], mine["ctx"])
    assert out["ctx"].dtype == np.int32
    assert (out["len"], out["prompt_len"], out["spos"], out["seed"]) == (
        6, 4, 3, 42)
    assert out["eos_id"] == 3 and out["epoch"] == 17
    assert out["sampling"].to_wire() == wire
    assert np.array_equal(out["spec_prompt"], np.arange(4))

    blob = encode_state(mine, prompt_len=4,
                        sampling=SamplingParams.from_wire(wire), eos_id=3,
                        epoch=17)
    back = jkv.decode_state(blob)
    assert back["kv"][0][0].dtype == theirs["kv"][0][0].dtype
    _same_kv(back["kv"], theirs["kv"])
    assert back["sampling"].to_wire() == wire
    assert back["epoch"] == 17

    # a prefix frame: JAX reads the port's, the port reads JAX's
    toks = np.arange(5, dtype=np.int32)
    pf = jkv.decode_state(kv_transfer.encode_prefix(toks, mine["kv"],
                                                    epoch=5))
    assert pf["len"] == pf["prompt_len"] == 5 and pf["epoch"] == 5
    _same_kv(pf["kv"], theirs["kv"])
    assert np.array_equal(pf["ctx"], toks)
    mp = decode_state(jkv.encode_prefix(toks, theirs["kv"]))
    assert mp["epoch"] is None and mp["sampling"] is None
    _same_kv(mp["kv"], mine["kv"])


def test_truncation_and_corruption_are_typed():
    """Every broken frame is a typed ``KvTransferError``: cut at any
    boundary, a flipped payload byte (the crc), a foreign magic, a future
    version, an unreadable header, a payload the header does not
    describe, an integer K/V dtype."""
    mine, _ = _states("float32")
    blob = encode_state(mine, prompt_len=4)
    for cut in (0, 3, 5, 9, len(blob) // 2, len(blob) - 1):
        with pytest.raises(KvTransferError):
            decode_state(blob[:cut])
    corrupt = bytearray(blob)
    corrupt[-8] ^= 0xFF  # deep in the payload: only the crc sees it
    with pytest.raises(KvTransferError):
        decode_state(bytes(corrupt))
    with pytest.raises(KvTransferError):
        decode_state(b"NOPE" + blob[4:])
    future = bytearray(blob)
    struct.pack_into(">H", future, 4, 99)
    with pytest.raises(KvTransferError):
        decode_state(bytes(future))
    hlen = struct.unpack_from(">I", blob, 6)[0]
    head = blob[10:10 + hlen]
    for bad in (b"{not json" + b" " * (hlen - 9),
                head.replace(b'"len": 6', b'"len": 7'),
                head.replace(b'"float32"', b'"int16"  ')):
        assert len(bad) == hlen
        with pytest.raises(KvTransferError):
            decode_state(blob[:10] + bad + blob[10 + hlen:])
    with pytest.raises(KvTransferError):
        encode_state(mine, prompt_len=0)
    with pytest.raises(KvTransferError):
        kv_transfer.encode_prefix(np.zeros(0, np.int32), [])
    assert issubclass(KvTransferError, ServingError)
    assert KvTransferError.code == "kv_transfer"


@pytest.mark.parametrize("kw", [{}, {"paged": True, "page_size": 4},
                                {"kv_dtype": torch.bfloat16}],
                         ids=["dense", "paged", "bf16"])
def test_real_swap_state_roundtrips(kw):
    """A real ``swap_out`` dict (dense, paged, bf16 caches) crosses the
    codec bit for bit; the frame is as long as the header says."""
    lm = zoo.transformer_lm(VOCAB, 32, 32, 2, 2, device="cpu")
    eng = ServingEngine(lm, num_slots=2, prefix_cache=False, device="cpu",
                        **kw)
    st = eng._stepper
    p = np.random.default_rng(3).integers(0, VOCAB, 7).astype(np.int32)
    left = st.begin_admit(0, p, **({"max_new": 4} if st.paged else {}))
    while left > 0:
        left = st.prefill_chunk(0, 8)
    state = st.swap_out(0)
    out = decode_state(encode_state(state, prompt_len=7))
    assert out["len"] == state["len"] == 7
    assert np.array_equal(out["ctx"], state["ctx"])
    _same_kv(out["kv"], state["kv"])
    assert out["kv"][0][0].shape == (6, 2, 16)


def _dead_endpoint():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return ("127.0.0.1", port)


def test_breaker_open_skips_fetch_without_budget_burn():
    """An open breaker skips the peer op outright: no dial, no retry
    budget withdrawn, no retry counted (``test_fabric.py:285``)."""
    from distkeras_tpu_torch.serving.resilience import OPEN

    fab = PeerFabric(
        retry_budget={"ratio": 0.0, "burst": 1.0},
        breaker={"window": 60.0, "min_requests": 1,
                 "failure_threshold": 0.01, "open_secs": 60.0},
        fetch_timeout=1.0, connect_timeout=0.2, max_fetch_retries=1,
    )
    ep = _dead_endpoint()
    try:
        # the wire death opens the breaker; the granted retry re-gates and
        # is refused by the now-open breaker
        with pytest.raises(PeerError):
            fab.fetch(ep, np.arange(8, dtype=np.int32), epoch=1)
        assert fab.breaker(ep).state == OPEN
        assert fab.counters["fetches"] == 1
        budget0 = fab.budget.snapshot()
        skips0 = fab.counters["breaker_skips"]
        retries0 = fab.counters["fetch_retries"]
        with pytest.raises(PeerError) as ei:
            fab.fetch(ep, np.arange(8, dtype=np.int32), epoch=1)
        assert "breaker" in str(ei.value)
        assert fab.counters["breaker_skips"] == skips0 + 1
        assert fab.counters["fetch_retries"] == retries0
        assert fab.budget.snapshot() == budget0  # not one token
        snap = fab.snapshot()
        assert snap["breakers"][f"{ep[0]}:{ep[1]}"]["state"] == OPEN
        assert snap["pooled_clients"] == 0
    finally:
        fab.close()


def test_push_to_dead_endpoint_is_typed_and_counted():
    fab = PeerFabric(connect_timeout=0.2, push_timeout=1.0)
    try:
        with pytest.raises(PeerError):
            fab.push(_dead_endpoint(), {"verb": "kv.transfer",
                                        "max_new_tokens": 2}, b"DKTX")
        assert fab.counters["pushes"] == 1
        assert fab.counters["push_degraded"] == 1
        assert fab.counters["push_ok"] == 0
    finally:
        fab.close()
