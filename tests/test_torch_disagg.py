"""Disaggregated prefill/decode in the port, against the JAX package.

The JAX counterparts: ``tests/test_disagg.py:140-392`` (prefill -> resume
identity, ``wrong_role``, a corrupt frame, the batcher's export and its
failure, the wire verbs). Here, on the same weights (bridged with
``params_from_jax``): a request prefilled on a ``role="prefill"`` port
engine and resumed on a ``role="decode"`` one decodes the tokens of JAX's
unified engine — dense, paged, sampled, bf16 caches, grammar-constrained
and onto an n-gram speculative engine; the failures are typed; the
batcher exports a prefill-only slot before any decode step in both loop
shapes; the ``prefill``/``kv.transfer`` verbs work over the wire (relayed,
streamed, pushed, and the push's degrade); and hand-offs cross
implementations both ways, a JAX ``tp:2`` prefill included.
"""

from __future__ import annotations

import socket
import types

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.serving import (
    ContinuousBatcher,
    KvTransferError,
    ServeRequest,
    ServingClient,
    ServingEngine,
    ServingError,
    ServingServer,
    TokenStream,
    WrongRoleError,
    encode_state,
)
from distkeras_tpu_torch.serving import kv_transfer
from distkeras_tpu_torch.utils.convert import params_from_jax
from distkeras_tpu_torch.utils.serialization import (
    deserialize_params,
    serialize_params,
)

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
SAMPLED = {"temperature": 0.8, "seed": 5}
GRAMMAR = {"temperature": 0.9, "top_p": 0.9, "seed": 6,
           "grammar": {"kind": "allow", "tokens": list(range(0, 61, 2))}}


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


@pytest.fixture(scope="module")
def jax_unified(lms):
    """JAX's unified engines by layout, built once: the references every
    hand-off is held against (same admission path: 4-token chunks)."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    engines = {}

    def get(layout):
        if layout not in engines:
            kw = {"dense": {}, "paged": {"paged": True, "page_size": 4},
                  "bf16": {"kv_dtype": _jbf16()}}[layout]
            engines[layout] = JEngine(lms[0], num_slots=2, prefill_chunk=4,
                                      prefix_cache=False, **kw).start()
        return engines[layout]

    yield get
    for eng in engines.values():
        eng.stop()


def _jbf16():
    import jax.numpy as jnp

    return jnp.bfloat16


def _prompt(n=9, seed=3):
    return np.random.default_rng(seed).integers(0, 61, n).astype(np.int32)


def _jax_ref(jax_unified, layout, p, n, sampling=None):
    from distkeras_tpu.serving.sampling import SamplingParams as JSampling

    return np.asarray(jax_unified(layout).generate(
        p, n, sampling=JSampling.from_wire(sampling)))


def _pair(lm, pre_kw=None, dec_kw=None):
    pre = ServingEngine(lm, num_slots=2, role="prefill", prefill_chunk=4,
                        prefix_cache=False, device="cpu",
                        **(pre_kw or {})).start()
    dec = ServingEngine(lm, num_slots=2, role="decode", prefix_cache=False,
                        device="cpu", **(dec_kw or {})).start()
    return pre, dec


# layout of the JAX reference, the pair's engine knobs, the prompt, and the
# sampling of the case's second request (the first is greedy)
CASES = {
    "dense": ("dense", {}, {}, _prompt(9), SAMPLED),
    "paged": ("paged", {"paged": True, "page_size": 4},
              {"paged": True, "page_size": 4}, _prompt(9), SAMPLED),
    "bf16": ("bf16", {"kv_dtype": torch.bfloat16},
             {"kv_dtype": torch.bfloat16}, _prompt(9), SAMPLED),
    "constrained": ("paged", {"paged": True, "page_size": 4},
                    {"paged": True, "page_size": 4}, _prompt(9), GRAMMAR),
    "ngram": ("dense", {}, {"speculative": "ngram", "draft_k": 4},
              np.tile(np.array([5, 9, 13], np.int32), 4), SAMPLED),
}


@pytest.mark.parametrize("case", list(CASES))
def test_prefill_resume_matches_jax_unified(lms, jax_unified, case):
    """The acceptance pin: prefill on one port engine, resume on another,
    token-identical to JAX's unified engine of the same layout, greedy
    and sampled (or constrained); the ledgers pair."""
    layout, pre_kw, dec_kw, p, sampling = CASES[case]
    pre, dec = _pair(lms[1], pre_kw, dec_kw)
    try:
        for sp in (None, sampling):
            blob, meta = pre.prefill(p, 8, sampling=sp)
            assert meta == {"len": p.size, "prompt_len": p.size,
                            "bytes": len(blob),
                            "version": kv_transfer.VERSION}
            out = dec.wait(dec.resume(blob, 8))
            want = _jax_ref(jax_unified, layout, p, 8, sp)
            assert out.tolist() == want.tolist(), sp
            if sp is not None and "grammar" in sp:
                allowed = set(sp["grammar"]["tokens"])
                assert set(out[p.size:].tolist()) <= allowed
        assert pre.stats()["exports"] == 2
        assert pre.stats()["tokens_generated"] == 0  # never decoded
        t_pre, t_dec = pre.transfer_snapshot(), dec.transfer_snapshot()
        assert t_pre["sends"] == t_dec["recvs"] == 2
        assert t_pre["bytes_out"] == t_dec["bytes_in"] > 0
        assert t_pre["errors"] == t_dec["errors"] == 0
        assert t_pre["pending"] == t_dec["pending"] == 0
        if dec_kw.get("speculative"):
            assert dec.stats()["speculative"]["windows"] > 0
    finally:
        pre.stop()
        dec.stop()


def test_wrong_role_is_typed(lms):
    lm = lms[1]
    pre, dec = _pair(lm)
    try:
        with pytest.raises(WrongRoleError):
            pre.generate(_prompt(5), 4)
        with pytest.raises(WrongRoleError):
            dec.prefill(_prompt(5), 4)
        blob, _ = pre.prefill(_prompt(5), 4)
        with pytest.raises(WrongRoleError):
            pre.resume(blob, 4)
        # a decode worker may still serve from scratch
        assert dec.generate(_prompt(5), 4).size == 9
        with pytest.raises(ValueError):
            ServingEngine(lm, role="nonsense", device="cpu")
        assert pre.health()["role"] == "prefill"
        assert dec.stats()["role"] == "decode"
        roles = {m["value"] for e in (pre, dec) for m in e.metrics_snapshot()
                 if m["name"] == "serving_engine_role_id"}
        assert roles == {1, 2}
    finally:
        pre.stop()
        dec.stop()


def test_resume_rejects_corrupt_and_misfit_frames_typed(lms):
    """A corrupt frame and a frame of another model's geometry are typed
    ``KvTransferError``; nothing is admitted and the tape names the
    class."""
    lm = lms[1]
    pre, dec = _pair(lm)
    try:
        with pytest.raises(KvTransferError):
            dec.resume(b"DKTXgarbage", 4)
        blob, _ = pre.prefill(_prompt(7), 4)
        flipped = bytearray(blob)
        flipped[len(blob) // 2 + 40] ^= 0x01
        with pytest.raises(KvTransferError):
            dec.resume(bytes(flipped), 4)
        state = kv_transfer.decode_state(blob)
        for misfit in (state["kv"][:1], [(k[:, :1], v[:, :1])
                                         for k, v in state["kv"]]):
            bad = dict(state, kv=misfit)
            with pytest.raises(KvTransferError):
                dec.resume(encode_state(bad, prompt_len=7), 4)
        assert dec.transfer_snapshot()["errors"] == 4
        assert dec.stats()["submitted"] == 0
        tape = [e for e in dec.recorder.snapshot()
                if e["kind"] == "kv.transfer.error"]
        assert tape and tape[-1]["error"] == "KvTransferError"
        # the same frame unharmed still resumes
        assert dec.wait(dec.resume(blob, 4)).size == 11
    finally:
        pre.stop()
        dec.stop()


# ------------------------------------------------- scheduler-level units


class _Handle:
    def __init__(self, toks):
        self.toks = toks

    def ready(self):
        return True

    def collect(self):
        return self.toks


class FakeSwapStepper:
    """A pure-Python stepper with the swap face; it records every decode
    mask, so a test can see that a prefill-only slot never took one."""

    def __init__(self, num_slots=2, max_len=32, overlap=False):
        self.num_slots = num_slots
        self.max_len = max_len
        self.swapped = []
        self.masks = []
        self.fail_swap = False
        self._left = np.zeros(num_slots, int)
        self._n = np.zeros(num_slots, int)
        if overlap:
            self.step_async = lambda active: _Handle(self.step(active))

    def begin_admit(self, slot, prompt):
        self._left[slot] = max(0, len(np.asarray(prompt)) - 1)
        self._n[slot] = 0
        return int(self._left[slot])

    def prefill_chunk(self, slot, budget):
        n = min(int(budget), int(self._left[slot]))
        self._left[slot] -= n
        return int(self._left[slot])

    def release(self, slot):
        pass

    def step(self, active):
        self.masks.append(np.array(active, bool))
        toks = np.full(self.num_slots, -1)
        for i in np.flatnonzero(active):
            self._n[i] += 1
            toks[i] = 100 + i * 10 + self._n[i]
        return toks

    def swap_out(self, slot):
        if self.fail_swap:
            raise RuntimeError("export boom")
        self.swapped.append(slot)
        return {"len": 5, "ctx": np.arange(5, dtype=np.int32), "kv": [],
                "spos": 0, "seed": 0, "params": None, "grammar": None,
                "spec_prompt": None}


def _run(b, *reqs, steps=20):
    for _ in range(steps):
        if all(r.done for r in reqs):
            return
        b.step()


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlapped"])
def test_scheduler_prefill_only_exports(overlap):
    """A prefill-only request is exported and completed without a decode
    step while a plain request decodes beside it, in both loop shapes."""
    st = FakeSwapStepper(overlap=overlap)
    b = ContinuousBatcher(st, prefill_chunk=2, overlap=overlap)
    plain = b.submit(ServeRequest(np.arange(3), 6))
    req = b.submit(ServeRequest(np.arange(7), 4, prefill_only=True))
    _run(b, plain, req)
    assert req.done and req.error is None
    assert req.export is not None and req.export["len"] == 5
    assert req.tokens == []
    assert st.swapped == [1]
    assert not any(m[1] for m in st.masks)  # slot 1 never stepped
    assert plain.error is None and len(plain.tokens) == 6
    assert b.counters["exports"] == 1
    assert b.counters["completed"] == 2
    assert b.counters["export_failures"] == 0


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlapped"])
def test_scheduler_export_failure_is_typed(overlap):
    st = FakeSwapStepper(overlap=overlap)
    st.fail_swap = True
    b = ContinuousBatcher(st, prefill_chunk=8, overlap=overlap)
    req = b.submit(ServeRequest(np.arange(4), 4, prefill_only=True))
    _run(b, req)
    assert req.done and req.error is not None
    assert req.error.code == "internal"
    assert b.counters["export_failures"] == 1
    assert not any(m.any() for m in st.masks)
    # the slot recycled: a plain request serves afterwards
    st.fail_swap = False
    req2 = b.submit(ServeRequest(np.arange(3), 2))
    _run(b, req2)
    assert req2.error is None and len(req2.tokens) == 2


def test_submit_refuses_streamed_grouped_and_swapless_prefill():
    from distkeras_tpu_torch.serving import SamplingParams

    st = FakeSwapStepper()
    st.can_fork = True
    b = ContinuousBatcher(st)
    with pytest.raises(ValueError, match="stream"):
        b.submit(ServeRequest(np.arange(3), 2, stream=True,
                              prefill_only=True))
    with pytest.raises(ValueError, match="prefill-exported"):
        b.submit(ServeRequest(np.arange(3), 2, prefill_only=True,
                              sampling=SamplingParams(n=2)))
    swapless = types.SimpleNamespace(num_slots=2, max_len=32)
    with pytest.raises(ValueError, match="swap_out"):
        ContinuousBatcher(swapless).submit(
            ServeRequest(np.arange(3), 2, prefill_only=True))


# ------------------------------------------------------------- wire e2e


def _dead_endpoint():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return ("127.0.0.1", port)


def _wire_prefill(c, p, n, **extra):
    reply, blob = c._roundtrip(
        dict({"verb": "prefill", "max_new_tokens": n}, **extra),
        serialize_params(p))
    return reply, bytes(blob)


def _wire_transfer(c, blob, n, **extra):
    reply, body = c._roundtrip(
        dict({"verb": "kv.transfer", "max_new_tokens": n}, **extra), blob)
    return reply, np.asarray(deserialize_params(body))


def test_wire_prefill_transfer_stream_and_push(lms, jax_unified):
    """Over loopback: ``prefill`` then ``kv.transfer`` (relayed), the
    streamed ``kv.transfer``, ``prefill`` with ``push_to`` (the decode
    reply comes back ``pushed: true``) and its degrade (a dead decode
    worker: ``pushed: false``, the frame handed back and still good)."""
    lm = lms[1]
    pre, dec = _pair(lm)
    s1, s2 = ServingServer(pre).start(), ServingServer(dec).start()
    p = _prompt(9, seed=11)
    want = _jax_ref(jax_unified, "dense", p, 8)
    want_s = _jax_ref(jax_unified, "dense", p, 8, SAMPLED)
    try:
        with ServingClient(s1.host, s1.port) as c1, \
                ServingClient(s2.host, s2.port) as c2:
            reply, blob = _wire_prefill(c1, p, 8)
            assert reply["ok"] and reply["transfer"]["bytes"] == len(blob)
            r2, out = _wire_transfer(c2, blob, 8)
            assert r2["ok"] and r2["tokens"] == 8
            assert out.tolist() == want.tolist()

            _, blob = _wire_prefill(c1, p, 8, sampling=SAMPLED)
            st = TokenStream(c2, {"verb": "kv.transfer", "stream": True,
                                  "max_new_tokens": 8}, blob)
            chunks = [list(ch) for ch in st]
            assert st.sequence.tolist() == want_s.tolist()
            assert [t for ch in chunks for t in ch] == want_s[9:].tolist()

            reply, body = c1._roundtrip(
                {"verb": "prefill", "max_new_tokens": 8,
                 "push_to": [s2.host, s2.port]}, serialize_params(p))
            assert reply["ok"] and reply["pushed"] is True
            assert np.asarray(deserialize_params(body)).tolist() == (
                want.tolist())
            fab = pre.peer_fabric.counters
            assert fab["pushes"] == fab["push_ok"] == 1
            assert fab["bytes_out"] == reply["transfer"]["bytes"]

            reply, blob = _wire_prefill(c1, p, 8,
                                        push_to=list(_dead_endpoint()))
            assert reply["ok"] and reply["pushed"] is False
            assert reply["push_error"] == "kv_peer"
            assert _wire_transfer(c2, blob, 8)[1].tolist() == want.tolist()
            assert fab["push_degraded"] == 1
            assert dec.transfer_snapshot()["recvs"] == 4

            # typed over the wire, both ways
            for c, hdr, payload, code in (
                    (c1, {"verb": "generate", "max_new_tokens": 4},
                     serialize_params(p), "wrong_role"),
                    (c2, {"verb": "prefill", "max_new_tokens": 4},
                     serialize_params(p), "wrong_role"),
                    (c2, {"verb": "kv.transfer", "max_new_tokens": 4},
                     b"DKTXjunk", "kv_transfer")):
                with pytest.raises(ServingError) as ei:
                    c._roundtrip(hdr, payload)
                assert ei.value.code == code
    finally:
        s1.shutdown()
        s2.shutdown()


@pytest.mark.chaos
def test_kv_transfer_seam_both_directions_typed(lms):
    """The ``kv.transfer`` seam: a raise on the send side fails only that
    prefill, typed ``internal``; on the recv side the resume fails typed
    and the tape names the injected class; the next hand-off is clean."""
    from distkeras_tpu_torch.faults import FaultPlan, InjectedFault

    pre, dec = _pair(lms[1])
    p = _prompt(7, seed=17)
    try:
        blob, _ = pre.prefill(p, 4)
        want = dec.wait(dec.resume(blob, 4))
        plan = FaultPlan(seed=0).arm(
            "kv.transfer", times=1,
            when=lambda ctx: ctx.get("direction") == "send")
        with plan:
            with pytest.raises(ServingError) as ei:
                pre.prefill(p, 4)
        assert ei.value.code == "internal"
        assert plan.fired("kv.transfer") == 1
        assert pre.transfer_snapshot()["errors"] == 1
        plan = FaultPlan(seed=0).arm(
            "kv.transfer", times=1,
            when=lambda ctx: ctx.get("direction") == "recv")
        with plan:
            with pytest.raises(ServingError):
                dec.resume(blob, 4)
        assert plan.fired("kv.transfer") == 1
        tape = [e for e in dec.recorder.snapshot()
                if e["kind"] == "kv.transfer.error"]
        assert tape and tape[-1]["error"] == InjectedFault.__name__
        blob, _ = pre.prefill(p, 4)
        assert dec.wait(dec.resume(blob, 4)).tolist() == want.tolist()
    finally:
        pre.stop()
        dec.stop()


# ---------------------------------------------- across implementations


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_jax_prefill_hands_off_to_port_decode(lms, jax_unified, sampled):
    """A JAX prefill engine behind a JAX server hands off to a port decode
    engine behind a port server: relayed by the caller, and pushed
    worker-to-worker by JAX's peer fabric. Both equal JAX's unified
    decode."""
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu.serving import ServingServer as JServer

    jpre = JEngine(lms[0], num_slots=2, role="prefill", prefill_chunk=4,
                   prefix_cache=False)
    dec = ServingEngine(lms[1], num_slots=2, role="decode",
                        prefix_cache=False, device="cpu")
    s1, s2 = JServer(jpre).start(), ServingServer(dec).start()
    p = _prompt(9, seed=21)
    sp = SAMPLED if sampled else None
    want = _jax_ref(jax_unified, "dense", p, 8, sp)
    extra = {"sampling": sp} if sp else {}
    try:
        with ServingClient(s1.host, s1.port) as c1, \
                ServingClient(s2.host, s2.port) as c2:
            _, blob = _wire_prefill(c1, p, 8, **extra)
            assert _wire_transfer(c2, blob, 8)[1].tolist() == want.tolist()
            reply, body = c1._roundtrip(
                dict({"verb": "prefill", "max_new_tokens": 8,
                      "push_to": [s2.host, s2.port]}, **extra),
                serialize_params(p))
            assert reply["pushed"] is True
            assert np.asarray(deserialize_params(body)).tolist() == (
                want.tolist())
        assert dec.transfer_snapshot()["recvs"] == 2
    finally:
        s1.shutdown()
        s2.shutdown()


@pytest.mark.parametrize("sampled", [False, True], ids=["greedy", "sampled"])
def test_port_prefill_hands_off_to_jax_decode(lms, jax_unified, sampled):
    """The reverse: a port prefill engine (paged) behind a port server
    hands off to a JAX decode engine behind a JAX server, relayed and
    pushed by the port's peer fabric, equal to JAX's unified decode."""
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu.serving import ServingServer as JServer

    pre = ServingEngine(lms[1], num_slots=2, role="prefill", prefill_chunk=4,
                        prefix_cache=False, paged=True, page_size=4,
                        device="cpu")
    jdec = JEngine(lms[0], num_slots=2, role="decode", prefix_cache=False)
    s1, s2 = ServingServer(pre).start(), JServer(jdec).start()
    p = _prompt(9, seed=23)
    sp = SAMPLED if sampled else None
    want = _jax_ref(jax_unified, "dense", p, 8, sp)
    extra = {"sampling": sp} if sp else {}
    try:
        with ServingClient(s1.host, s1.port) as c1, \
                ServingClient(s2.host, s2.port) as c2:
            _, blob = _wire_prefill(c1, p, 8, **extra)
            assert _wire_transfer(c2, blob, 8)[1].tolist() == want.tolist()
            reply, body = c1._roundtrip(
                dict({"verb": "prefill", "max_new_tokens": 8,
                      "push_to": [s2.host, s2.port]}, **extra),
                serialize_params(p))
            assert reply["pushed"] is True
            assert np.asarray(deserialize_params(body)).tolist() == (
                want.tolist())
        assert pre.peer_fabric.counters["push_ok"] == 1
    finally:
        s1.shutdown()
        s2.shutdown()


def test_jax_tp2_prefill_resumes_in_the_port(lms, jax_unified, tp_mesh):
    """A slot prefilled on a JAX ``tp:2`` engine (gathered full-head rows
    in the frame) resumes on a port decode engine, dense and paged,
    token-identical to JAX's unified decode."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    jpre = JEngine(lms[0], num_slots=2, role="prefill", prefill_chunk=4,
                   prefix_cache=False, mesh=tp_mesh(2)).start()
    decs = [ServingEngine(lms[1], num_slots=2, role="decode",
                          prefix_cache=False, device="cpu", **kw).start()
            for kw in ({}, {"paged": True, "page_size": 4})]
    p = _prompt(9, seed=5)
    try:
        for sp in (None, SAMPLED):
            from distkeras_tpu.serving.sampling import SamplingParams as JS

            blob, _ = jpre.prefill(p, 6, sampling=JS.from_wire(sp))
            want = _jax_ref(jax_unified, "dense", p, 6, sp)
            for dec in decs:
                out = dec.wait(dec.resume(blob, 6))
                assert out.tolist() == want.tolist(), sp
    finally:
        jpre.stop()
        for dec in decs:
            dec.stop()


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_handoff_on_card_equals_unified_card_engine():
    """On CUDA: a prefill -> resume hand-off (dense and paged, f32 and
    bf16 caches) is token-identical to a unified CUDA engine of the same
    layout, greedy and sampled."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lm = zoo.transformer_lm(**LM, device="cuda")
    p = _prompt(9)
    for kw in ({}, {"paged": True, "page_size": 4},
               {"kv_dtype": torch.bfloat16}):
        common = dict(num_slots=2, prefill_chunk=4, prefix_cache=False,
                      device="cuda", **kw)
        pre = ServingEngine(lm, role="prefill", **common).start()
        dec = ServingEngine(lm, role="decode", **common).start()
        uni = ServingEngine(lm, **common).start()
        try:
            for sp in (None, SAMPLED):
                blob, _ = pre.prefill(p, 8, sampling=sp)
                out = dec.wait(dec.resume(blob, 8))
                assert out.tolist() == uni.generate(p, 8,
                                                    sampling=sp).tolist()
        finally:
            for e in (pre, dec, uni):
                e.stop()
