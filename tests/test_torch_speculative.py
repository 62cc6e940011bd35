"""The port's speculative decode against the JAX package.

The bars, inherited from the JAX package's ``tests/test_serving.py``,
``test_sampling.py``, ``test_lm.py`` and ``test_faults.py``: a greedy slot
decoded through draft -> verify -> rollback equals its solo
``CachedSequenceGenerator`` decode token for token (the port's and JAX's)
on every admission path, whatever the drafter proposes; a sampled stream
equals the plain sampled stream; the batcher emits a variable 1..k+1
tokens per window with the budget, EOS and deadline checked per token.
Beside them, the cross-implementation pins: the window samplers equal
JAX's on the same logits, one verify window writes JAX's context rows and
caches, and the port's speculative stepper emits the JAX stepper's tokens
(n-gram and self-draft, greedy and sampled).

All on the CPU, on a small LM (vocab 64, seq 64, d32, 4 heads, depth 2)
with JAX's weights carried into the port; the paged tier is in
``test_torch_paged_speculative.py``. JAX is imported inside the fixtures
and tests, so the ``gpu``-marked case also runs on a machine without it
(``python -m pytest --noconftest tests/test_torch_speculative.py -m
gpu``). Token comparisons are exact; cache comparisons hold to 1e-5
absolute (the f32 summation order of the two implementations' products).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.faults import FaultPlan
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.predictors import (
    CachedSequenceGenerator,
    SpeculativeGenerator,
)
from distkeras_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeStepper,
    InternalError,
    ModelDrafter,
    NgramDrafter,
    ServeRequest,
    ServingEngine,
)
from distkeras_tpu_torch.serving import sampling as sp
from distkeras_tpu_torch.serving import scheduler as psched
from distkeras_tpu_torch.serving.scheduler import DeadlineExceededError
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=64, seq_len=64, d_model=32, num_heads=4, depth=2)
VOCAB = LM["vocab_size"]


@pytest.fixture(autouse=True)
def _no_leaked_plan():
    yield
    leaked = faults._ACTIVE
    if leaked is not None:
        leaked.deactivate()
        pytest.fail("test leaked an active FaultPlan")


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


@pytest.fixture(scope="module")
def drafts():
    """A one-block draft (JAX's and the port's, same weights) that
    disagrees with the target most of the time."""
    import jax

    from distkeras_tpu.models import zoo as jzoo

    kw = dict(vocab_size=VOCAB, seq_len=LM["seq_len"], d_model=16,
              num_heads=2, depth=1)
    jd = jzoo.transformer_lm(**kw, seed=9)
    d = zoo.transformer_lm(**kw, device="cpu")
    params_from_jax(d, jax.tree.map(np.asarray, jd.params))
    return jd, d


@pytest.fixture(scope="module")
def solo(lms):
    """``solo(prompt, steps)``: the port's solo greedy continuation, held
    equal to JAX's."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    jlm, lm = lms
    jref = JCached(jlm)
    pref = CachedSequenceGenerator(lm, device="cpu")

    def run(p, s):
        want = jref.generate(np.asarray(p, np.int32)[None], steps=s)[0]
        got = pref.generate(np.asarray(p)[None], s)[0]
        np.testing.assert_array_equal(got, want)
        return got[len(p):].tolist()

    return run


def _prompt(n, seed):
    return np.random.default_rng(seed).integers(0, VOCAB, n).astype(np.int32)


def _spec_decode(st, slot, prompt, steps, seqs=True):
    """Drive ``spec_step`` for one slot until ``steps`` tokens came out."""
    out = []
    while len(out) < steps:
        active = np.zeros(st.num_slots, bool)
        active[slot] = True
        s = None
        if seqs:
            s = [None] * st.num_slots
            s[slot] = np.concatenate([prompt, np.asarray(out, np.int32)])
        toks, counts, _ = st.spec_step(active, s)
        out.extend(int(t) for t in np.atleast_1d(toks[slot])[: counts[slot]])
    return out[:steps]


def _wait(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


class FixedDrafter:
    """The drafter protocol with fixed proposals: row i proposes
    ``dtoks[i, :dcnt[i]]`` every window (both packages' steppers take it)."""

    name = "fixed"
    wants_sequences = False

    def __init__(self, dtoks, dcnt):
        self.dtoks = np.asarray(dtoks, np.int32)
        self.dcnt = np.asarray(dcnt, np.int32)

    def bind(self, stepper):
        pass

    def warmup(self):
        pass

    def admit(self, slot, prompt):
        pass

    def release(self, slot):
        pass

    def invalidate(self, mask):
        pass

    def sync(self, active, toks, counts, lens0):
        pass

    def propose(self, active, k, seqs):
        return self.dtoks.copy(), np.where(active, self.dcnt, 0).astype(
            np.int32)


# ------------------------------------------------------- window samplers


def test_check_spec_sampling_shared_helper():
    assert sp.check_spec_sampling("rejection", 0.9, 5, 0.9) == "rejection"
    assert sp.check_spec_sampling("strict", 0.0, None, None) == "strict"
    with pytest.raises(ValueError, match="GREEDY"):
        sp.check_spec_sampling("strict", 0.5, None, None)
    with pytest.raises(ValueError):
        sp.check_spec_sampling("bogus")
    from distkeras_tpu.serving import sampling as jsp

    assert sp.SPEC_GREEDY_MSG == jsp.SPEC_GREEDY_MSG


def _window_case(seed, b=6, c=5, v=VOCAB):
    """Seeded (B, C, V) logits with drafts that agree with the argmax for
    a row-dependent prefix, and per-row sampling arrays."""
    rng = np.random.default_rng(seed)
    logit = (rng.standard_normal((b, c, v)) * 2).astype(np.float32)
    dtoks = rng.integers(0, v, (b, c - 1)).astype(np.int32)
    arg = logit.argmax(-1)
    for i in range(b):
        agree = i % c  # rows agree for 0..c-1 leading proposals
        dtoks[i, :agree] = arg[i, :agree]
    dcnt = rng.integers(0, c, b).astype(np.int32)
    dcnt[0] = c - 1
    return logit, dtoks, dcnt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_greedy_window_tokens_match_jax(seed):
    import jax.numpy as jnp

    from distkeras_tpu.serving import sampling as jsp

    logit, dtoks, dcnt = _window_case(seed)
    want_t, want_n = jsp.greedy_window_tokens(
        jnp.asarray(logit), jnp.asarray(dtoks), jnp.asarray(dcnt))
    got_t, got_n = sp.greedy_window_tokens(
        torch.from_numpy(logit), torch.from_numpy(dtoks),
        torch.from_numpy(dcnt))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))


@pytest.mark.parametrize("filtered", [False, True])
def test_spec_window_tokens_match_jax(filtered):
    """Mixed greedy and sampled rows; the sampled rows' drafts are set to
    JAX's own draws for a row-dependent prefix, so every acceptance length
    occurs."""
    import jax.numpy as jnp

    from distkeras_tpu.serving import sampling as jsp

    logit, dtoks, dcnt = _window_case(7)
    b, c, _ = logit.shape
    temps = np.array([0.0, 0.8, 1.1, 0.0, 0.7, 0.9], np.float32)
    topk = np.array([0, 0, 5, 0, 0, 9] if filtered else [0] * b)
    topp = np.array([1, 1, 1, 1, 0.9, 1] if filtered else [1] * b,
                    np.float32)
    seeds = np.array([3, 9, 11, 0, 5, 101])
    spos = np.array([0, 4, 2, 7, 1, 9])

    def jax_window(d):
        return jsp.spec_window_tokens(
            jnp.asarray(logit), jnp.asarray(d), jnp.asarray(dcnt),
            jnp.asarray(temps), jnp.asarray(topk, jnp.int32),
            jnp.asarray(topp), jnp.asarray(seeds, jnp.int32),
            jnp.asarray(spos, jnp.int32))

    draws = np.asarray(jax_window(dtoks)[0])
    for i in np.flatnonzero(temps > 0):
        dtoks[i, : i % c] = draws[i, : i % c]
    want_t, want_n = jax_window(dtoks)
    got_t, got_n = sp.spec_window_tokens(*(torch.from_numpy(np.asarray(a))
                                           for a in (logit, dtoks, dcnt,
                                                     temps, topk, topp,
                                                     seeds, spos)))
    np.testing.assert_array_equal(got_t.numpy(), np.asarray(want_t))
    np.testing.assert_array_equal(got_n.numpy(), np.asarray(want_n))
    assert sorted(set(got_n.tolist())) == sorted(set(np.asarray(
        want_n).tolist())) and len(set(got_n.tolist())) >= 3


def test_spec_window_emits_the_plain_steps_draws():
    """The pointwise identity the slice rests on: a sampled window's token
    at candidate j is exactly ``sample_tokens`` at emitted position
    ``spos + j`` on that position's logits."""
    logit, dtoks, dcnt = _window_case(11)
    b, c, _ = logit.shape
    temps = torch.tensor([0.8, 1.3, 0.6, 0.9, 1.0, 0.5])
    topk = torch.tensor([0, 7, 0, 3, 0, 0])
    topp = torch.tensor([1.0, 1.0, 0.8, 1.0, 1.0, 0.95])
    seeds = torch.tensor([1, 2, 3, 4, 5, 6])
    spos = torch.tensor([0, 3, 8, 1, 2, 30])
    out, _ = sp.spec_window_tokens(
        torch.from_numpy(logit), torch.from_numpy(dtoks),
        torch.from_numpy(dcnt), temps, topk, topp, seeds, spos)
    for j in range(c):
        want = sp.sample_tokens(torch.from_numpy(logit[:, j]), temps, topk,
                                topp, seeds, spos + j)
        np.testing.assert_array_equal(out[:, j].numpy(), want.numpy())


# ------------------------------------------- the batcher's variable advance


class FakeStepper:
    """Slot ``i`` emits ``base + i*100 + n`` for its n-th token (JAX's
    test fake, taking the port's ``sampling`` keyword)."""

    def __init__(self, num_slots=2, max_len=32, base=1000):
        self.num_slots, self.max_len, self.base = num_slots, max_len, base
        self.released = []
        self._n = np.zeros(num_slots, int)
        self._left = np.zeros(num_slots, int)

    def begin_admit(self, slot, prompt, sampling=None):
        self._n[slot] = 0
        self._left[slot] = max(0, len(np.asarray(prompt)) - 1)
        return int(self._left[slot])

    def prefill_chunk(self, slot, budget):
        n = min(int(budget), int(self._left[slot]))
        self._left[slot] -= n
        return int(self._left[slot])

    def release(self, slot):
        self.released.append(slot)

    def step(self, active):
        toks = np.full(self.num_slots, -1)
        for i in np.flatnonzero(active):
            self._n[i] += 1
            toks[i] = self.base + i * 100 + self._n[i]
        return toks


class FakeSpecStepper(FakeStepper):
    """JAX's variable-advance fake: every verify emits a window of
    ``window`` tokens per active slot."""

    speculative = True
    wants_sequences = False
    draft_k = 3

    def __init__(self, num_slots=2, max_len=32, base=1000, window=3):
        super().__init__(num_slots, max_len, base)
        self.window = window
        self.spec_verify_steps = 0
        self.spec_fallback_steps = 0
        self.spec_drafted_tokens = 0
        self.drafter = type("D", (), {"name": "fake"})()

    def spec_step(self, active, seqs=None):
        active = np.asarray(active, bool)
        w = self.window
        toks = np.zeros((self.num_slots, w), int)
        for i in np.flatnonzero(active):
            for c in range(w):
                self._n[i] += 1
                toks[i, c] = self.base + i * 100 + self._n[i]
        self.spec_verify_steps += 1
        self.spec_drafted_tokens += (w - 1) * int(active.sum())
        return toks, np.where(active, w, 0), True


def _req(plen=3, max_new=4, **kw):
    return ServeRequest(np.arange(1, plen + 1), max_new, **kw)


@pytest.mark.parametrize("overlap", [False, True])
def test_spec_variable_advance_and_budget_cap_per_token(overlap):
    """1..k+1 tokens per iteration; the budget is checked per emitted
    token, so a window overrunning it emits up to it and frees the slot
    the same iteration."""
    st = FakeSpecStepper(num_slots=1, window=3)
    b = ContinuousBatcher(st, overlap=overlap)
    r = b.submit(_req(max_new=5))
    b.step()
    if overlap:
        b.step()  # the overlapped loop collects on its next call
    assert len(r.tokens) == 3 and not r.done
    b.step()
    assert r.done and len(r.tokens) == 5
    assert r.result().tolist() == [1, 2, 3, 1001, 1002, 1003, 1004, 1005]
    assert st.released == [0]
    s = b.stats()
    assert s["spec_windows"] == 2 and s["spec_tokens"] == 5
    assert s["spec_draft_accepted"] == 2 + 2
    spec = s["speculative"]
    assert spec["enabled"] and spec["draft_source"] == "fake"
    assert spec["mean_tokens_per_window"] == 2.5
    assert spec["per_slot_acceptance"][0] == 2.5
    assert spec["drafted_tokens"] == 4 and spec["rejected_draft_tokens"] == 0


def test_spec_eos_mid_window_frees_slot_same_iteration():
    st = FakeSpecStepper(num_slots=1, window=4)
    b = ContinuousBatcher(st)
    r0 = b.submit(_req(max_new=10, eos_id=1002))  # 2nd token of window 1
    r1 = b.submit(_req(max_new=2, eos_id=None))
    b.step()
    assert r0.done and len(r0.tokens) == 2  # the window's tail dropped
    assert r0.result().tolist() == [1, 2, 3, 1001, 1002]
    assert st.released == [0]
    b.step()  # the freed slot took r1
    assert r1.done and len(r1.tokens) == 2
    assert b.stats()["spec_tokens"] == 4


def test_spec_deadline_mid_window_stops_emission():
    st = FakeSpecStepper(num_slots=1, window=4)
    b = ContinuousBatcher(st)
    r = b.submit(_req(max_new=20, deadline=time.monotonic() + 0.05))
    b.step()
    assert len(r.tokens) == 4 and not r.done
    time.sleep(0.08)  # the deadline expires while the window "computes"
    b.step()
    assert r.done
    with pytest.raises(DeadlineExceededError):
        r.result()
    assert len(r.tokens) == 5  # one token lands, the tail is dropped
    assert st.released == [0]


def test_spec_stream_chunk_is_the_window_before_eviction():
    """A streamed request gets one chunk per window (the emitted part of
    it), and the terminal sentinel after the last one."""
    st = FakeSpecStepper(num_slots=1, window=3)
    b = ContinuousBatcher(st)
    r = b.submit(_req(max_new=5, stream=True))
    b.step()
    b.step()
    chunks = []
    while True:
        c = r.next_chunk(timeout=1)
        if c is None:
            break
        chunks.append(c)
    assert chunks == [[1001, 1002, 1003], [1004, 1005]]
    assert b.stats()["streamed_chunks"] == 2


def test_spec_fake_matches_jax_batcher():
    """The same seeded scenario (variable windows, an EOS, budgets,
    a queue) through JAX's ``ContinuousBatcher`` and the port's: equal
    replies and equal books."""
    from distkeras_tpu.serving import scheduler as jsched

    def run(mod):
        st = FakeSpecStepper(num_slots=2, window=3)
        b = mod.ContinuousBatcher(st)
        reqs = [b.submit(mod.ServeRequest(np.arange(1, 4 + i), 4 + i,
                                          eos_id=1105 if i == 1 else None))
                for i in range(4)]
        for _ in range(20):
            if b.idle:
                break
            b.step()
        keys = ("spec_windows", "spec_tokens", "spec_draft_accepted",
                "tokens_generated", "completed")
        s = b.stats()
        return ([r.result().tolist() for r in reqs], {k: s[k] for k in keys},
                s["speculative"]["per_slot_acceptance"])

    assert run(psched) == run(jsched)


# --------------------------------------------------- the stepper, dense


def test_plain_stepper_keeps_shapes_keys_and_tokens(lms, solo):
    """No drafter: no scratch, the PR's shapes and program keys, and the
    solo tokens."""
    _, lm = lms
    st = DecodeStepper(lm, num_slots=2, device="cpu")
    assert (st._tp, st._lens_cap, st.speculative) == (64, 64, False)
    assert tuple(st._ctx.shape) == (2, 64)
    assert tuple(st._caches[0][0].shape) == (2, 64, 4, 8)
    st.warmup()
    p = _prompt(9, 3)
    st.admit(0, p)
    out = []
    for _ in range(6):
        out.append(int(st.step(np.array([True, False]))[0]))
    assert out == solo(p, 6)
    assert {k for k, _ in st._called} == {"step[plain]", "ctx_row",
                                          "admit[8]"}


def test_spec_stepper_pads_the_time_axis(lms):
    _, lm = lms
    st = DecodeStepper(lm, num_slots=2, speculative=NgramDrafter(),
                       draft_k=3, device="cpu")
    assert (st._kb, st._tp, st._lens_cap) == (4, 69, 68)
    assert tuple(st._ctx.shape) == (2, 69)
    assert tuple(st._caches[0][0].shape) == (2, 69, 4, 8)
    assert st._t_idx.numel() >= st._tp
    assert st.speculative and st.wants_sequences
    with pytest.raises(ValueError, match="draft_k"):
        DecodeStepper(lm, speculative=NgramDrafter(), draft_k=0,
                      device="cpu")


def test_stepper_spec_ngram_matches_solo_all_paths(lms, solo):
    """Prompt lookup stays on the solo stream on every admission path —
    full, chunked, prefix-store hit — for a repetitive prompt (proposals
    fire) and a random one (rejection-heavy)."""
    from distkeras_tpu_torch.serving import PrefixStore

    _, lm = lms
    store = PrefixStore(max_bytes=8 << 20)
    st = DecodeStepper(lm, num_slots=2, prefix_cache=store,
                       speculative=NgramDrafter(), draft_k=4, device="cpu")
    rep = np.array([5, 9, 5, 9, 5, 9, 5, 9, 5], np.int32)
    rnd = _prompt(13, 23)
    for slot, p in ((0, rep), (1, rnd)):
        st.admit(slot, p)
    for slot, p in ((0, rep), (1, rnd)):
        assert _spec_decode(st, slot, p, 7) == solo(p, 7)
        st.release(slot)
    assert st.spec_verify_steps > 0
    left = st.begin_admit(0, rep)
    while left:
        left = st.prefill_chunk(0, 3)
    assert _spec_decode(st, 0, rep, 6) == solo(rep, 6)
    st.release(0)
    for _ in range(2):  # two touches: the store keeps the rung
        st.admit(1, rnd)
        st.release(1)
    left = st.begin_admit(1, rnd)
    assert 0 < left < rnd.size - 1 and store.stats()["hits"] >= 1
    while left:
        left = st.prefill_chunk(1, 3)
    assert _spec_decode(st, 1, rnd, 6) == solo(rnd, 6)


def test_stepper_spec_self_draft_is_the_ceiling(lms, solo):
    """A draft that always agrees (the target itself) accepts k+1 tokens
    every window, and the output stays the solo greedy stream."""
    _, lm = lms
    st = DecodeStepper(lm, num_slots=2, speculative=ModelDrafter(lm),
                       draft_k=3, device="cpu")
    prompt = _prompt(6, 24)
    st.admit(0, prompt)
    out = []
    active = np.array([True, False])
    while len(out) < 12:
        toks, counts, used = st.spec_step(active)
        assert used and counts[0] == 4
        out.extend(int(t) for t in toks[0][: counts[0]])
    assert out[:12] == solo(prompt, 12)
    assert st.spec_verify_steps == 3 and st.spec_fallback_steps == 0
    assert st.spec_drafted_tokens == 9


def test_small_draft_stays_on_the_solo_stream(lms, drafts, solo):
    """A disagreeing draft: the windows reject often and the output is
    still the solo stream, slot by slot, with the other slot busy."""
    _, lm = lms
    _, d = drafts
    st = DecodeStepper(lm, num_slots=2, speculative=ModelDrafter(d),
                       draft_k=4, device="cpu")
    p0, p1 = _prompt(5, 30), _prompt(11, 31)
    st.admit(0, p0)
    st.admit(1, p1)
    outs = [[], []]
    while min(len(o) for o in outs) < 10:
        toks, counts, _ = st.spec_step(np.array([True, True]))
        for i in (0, 1):
            outs[i].extend(int(t) for t in toks[i][: counts[i]])
    assert outs[0][:10] == solo(p0, 10) and outs[1][:10] == solo(p1, 10)


def test_drafter_failure_invalidates_the_slot_not_the_request(lms, solo):
    """A proposal that raises falls back to the plain step for that window
    (invalidated slots stop proposing), and the tokens stay solo."""
    _, lm = lms

    class Flaky(ModelDrafter):
        calls = 0

        def propose(self, active, k, seqs):
            Flaky.calls += 1
            if Flaky.calls == 2:
                raise RuntimeError("draft crashed")
            return super().propose(active, k, seqs)

    st = DecodeStepper(lm, num_slots=2, speculative=Flaky(lm), draft_k=3,
                       device="cpu")
    p = _prompt(7, 33)
    st.admit(0, p)
    assert _spec_decode(st, 0, p, 12, seqs=False) == solo(p, 12)
    assert st.spec_fallback_steps >= 1 and st.spec_verify_steps >= 1
    assert not st.drafter._valid[0]


def test_verify_window_matches_jax(lms):
    """One verify window with fixed proposals on both steppers (two slots
    decoding, one mid-prefill): equal accepted tokens, equal context rows
    over the padded axis, caches within 1e-5 at every written position."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    p0, p1, p2 = _prompt(9, 40), _prompt(4, 41), _prompt(20, 42)
    pstep = DecodeStepper(lm, num_slots=3, device="cpu",
                          speculative=NgramDrafter(), draft_k=4)
    jstep = JStepper(jlm, num_slots=3, speculative=NgramDrafter(),
                     draft_k=4)
    # proposals: slot 0 the solo continuation's first two tokens then
    # junk, slot 1 junk
    cont = CachedSequenceGenerator(lm, device="cpu").generate(p0[None], 4)[0]
    dtoks = np.array([[cont[9], cont[10], 1, 2], [3, 4, 5, 6], [0] * 4])
    dcnt = np.array([4, 3, 0])
    for st in (pstep, jstep):
        st.drafter = FixedDrafter(dtoks, dcnt)
        st.admit(0, p0)
        st.admit(1, p1)
        st.begin_admit(2, p2)
        st.prefill_chunk(2, 8)  # slot 2 mid-prefill: not active
    active = np.array([True, True, False])
    got = pstep.spec_step(active)
    want = jstep.spec_step(active)
    np.testing.assert_array_equal(got[0][:2], np.asarray(want[0])[:2])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][0] >= 3 and got[2] and want[2]
    np.testing.assert_array_equal(pstep._ctx.numpy(), np.asarray(jstep._ctx))
    np.testing.assert_array_equal(pstep._lens, jstep._lens)
    for (pk, pv), (jk, jv) in zip(pstep._caches, jstep._caches):
        for i, n in ((0, 9 - 1 + 5), (1, 4 - 1 + 5), (2, 8)):
            for parr, jarr in ((pk, jk), (pv, jv)):
                np.testing.assert_allclose(parr[i, :n].numpy(),
                                           np.asarray(jarr)[i, :n],
                                           atol=1e-5, rtol=0)


@pytest.mark.parametrize("drafter,sampled", [
    ("ngram", False), ("ngram", True), ("self", False), ("self", True),
])
def test_spec_stepper_matches_jax_stepper(lms, drafter, sampled):
    """The port's speculative stepper and JAX's, same admissions and the
    same windows, with churn: equal tokens and counts every window, equal
    verify/fallback books."""
    from distkeras_tpu.serving import ModelDrafter as JModelDrafter
    from distkeras_tpu.serving import NgramDrafter as JNgramDrafter
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper
    from distkeras_tpu.serving.sampling import SamplingParams as JParams

    jlm, lm = lms
    rng = np.random.default_rng(50)
    prompts = [((3 + np.arange(12)) % 7).astype(np.int32),
               rng.integers(0, VOCAB, 6).astype(np.int32),
               np.tile(rng.integers(0, VOCAB, 5), 3).astype(np.int32),
               rng.integers(0, VOCAB, 10).astype(np.int32)]
    params = [None, dict(temperature=0.8, seed=7), None,
              dict(temperature=1.1, top_k=9, seed=3)]
    if not sampled:
        params = [None] * 4
    steps = [9, 7, 10, 6]
    if drafter == "ngram":
        pd, jd = NgramDrafter(), JNgramDrafter()
    else:
        pd, jd = ModelDrafter(lm), JModelDrafter(jlm)
    pst = DecodeStepper(lm, num_slots=2, speculative=pd, draft_k=3,
                        device="cpu")
    jst = JStepper(jlm, num_slots=2, speculative=jd, draft_k=3)
    records = {}
    for name, st, mk in (("torch", pst, sp.SamplingParams),
                         ("jax", jst, JParams)):
        rec, outs = [], [[] for _ in prompts]
        queue = list(range(len(prompts)))
        serving = {}
        for it in range(60):
            for slot in range(2):
                if slot not in serving and queue:
                    ri = queue.pop(0)
                    sp_ = None if params[ri] is None else mk(**params[ri])
                    st.admit(slot, prompts[ri], sampling=sp_)
                    serving[slot] = ri
            if not serving:
                break
            active = np.zeros(2, bool)
            active[list(serving)] = True
            seqs = [(prompts[serving[i]], outs[serving[i]])
                    if i in serving else None for i in range(2)]
            toks, counts, used = st.spec_step(active, seqs)
            row = []
            for slot, ri in list(serving.items()):
                em = [int(t) for t in np.atleast_1d(toks[slot])[
                    : int(counts[slot])]]
                row.append((slot, em))
                outs[ri].extend(em)
                if len(outs[ri]) >= steps[ri]:
                    del serving[slot]
                    st.release(slot)
            rec.append((row, bool(used)))
        records[name] = (rec, [o[:s] for o, s in zip(outs, steps)],
                         st.spec_verify_steps, st.spec_fallback_steps,
                         st.spec_drafted_tokens)
    assert records["torch"] == records["jax"]
    assert records["torch"][2] > 0  # the verify ran


# -------------------------------------------------- batcher and engine


@pytest.mark.parametrize("overlap", [False, True])
def test_spec_verify_crash_blamed_like_decode_step(lms, solo, overlap):
    """A crashing verify (the ``stepper.verify`` seam) rides the decode
    step's blame machinery: the newest admission fails typed and is
    quarantined; the survivor's stream is exact (its cached proposals are
    re-verified, never re-drafted)."""
    _, lm = lms
    st = DecodeStepper(lm, num_slots=2, speculative=ModelDrafter(lm),
                       draft_k=3, device="cpu")
    b = ContinuousBatcher(st, quarantine_steps=3, overlap=overlap)
    p0, p1 = _prompt(5, 25), _prompt(8, 26)
    r0 = b.submit(ServeRequest(p0, 16))  # 4 full windows: outlives r1's
    b.step()                              # admission in both loop modes
    if overlap:
        b.step()
    r1 = b.submit(ServeRequest(p1, 8))
    with FaultPlan(seed=0).arm("stepper.verify", times=1):
        for _ in range(60):
            if r0.done and r1.done:
                break
            b.step()
    with pytest.raises(InternalError, match="blamed"):
        r1.result()
    assert r0.result()[5:].tolist() == solo(p0, 16)
    s = b.stats()
    assert s["step_failures"] == 1 and s["quarantines"] == 1
    assert s["blame_probes"] >= 1


def test_engine_speculative_wiring_and_validation(lms, solo):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, speculative="ngram", draft_k=4,
                        device="cpu").start()
    try:
        prompt = np.array([4, 11, 4, 11, 4, 11, 4], np.int32)
        np.testing.assert_array_equal(eng.generate(prompt, 8)[7:],
                                      solo(prompt, 8))
        spec = eng.stats()["speculative"]
        assert spec["enabled"] and spec["draft_source"] == "ngram"
        assert spec["draft_k"] == 4
        assert spec["windows"] + spec["fallback_steps"] > 0
        assert "per_slot_acceptance" in spec
        assert "speculative_tokens_per_window" in eng.health()
        assert eng.dump_postmortem("check")[0]["config"]["speculative"]
    finally:
        eng.stop()
    ServingEngine(lm, speculative="ngram", temperature=0.7, device="cpu")
    with pytest.raises(ValueError, match="GREEDY"):
        ServingEngine(lm, speculative="ngram", temperature=0.7,
                      spec_mode="strict", device="cpu")
    with pytest.raises(ValueError, match="draft_bundle"):
        ServingEngine(lm, speculative="draft", device="cpu")
    with pytest.raises(ValueError, match="draft_bundle"):
        ServingEngine(lm, draft_bundle="/nope.dkt", device="cpu")
    with pytest.raises(ValueError, match="speculative must be"):
        ServingEngine(lm, speculative="bogus", device="cpu")

    class CustomDrafter(NgramDrafter):
        name = "custom"

    eng = ServingEngine(lm, num_slots=1, speculative=CustomDrafter(),
                        device="cpu")
    assert eng.stats()["speculative"]["draft_source"] == "custom"
    plain = ServingEngine(lm, num_slots=1, device="cpu")
    assert plain.stats()["speculative"] == {"enabled": False}
    assert "speculative_tokens_per_window" not in plain.health()


def test_engine_draft_from_bundle(lms, drafts, solo, tmp_path):
    """``speculative=True`` with a bundle path: a ``ModelDrafter`` over
    the loaded (int8) draft, and the target's solo stream."""
    from distkeras_tpu_torch.ops.quantization import quantize_model
    from distkeras_tpu_torch.utils.serialization import save_serving_bundle

    _, lm = lms
    _, d = drafts
    path = str(tmp_path / "draft.dkt")
    save_serving_bundle(path, quantize_model(d.copy()))
    eng = ServingEngine(lm, num_slots=2, speculative=True, draft_bundle=path,
                        draft_k=2, device="cpu").start()
    try:
        p = _prompt(6, 60)
        assert eng.generate(p, 9)[6:].tolist() == solo(p, 9)
        spec = eng.stats()["speculative"]
        assert spec["draft_source"] == "draft_lm" and spec["windows"] > 0
    finally:
        eng.stop()


def test_spec_rejection_sampled_replay_and_greedy_pin(lms, solo):
    p = _prompt(5, 11)
    sps = sp.SamplingParams(temperature=0.8, seed=17)
    outs = []
    _, lm = lms
    for _ in range(2):
        eng = ServingEngine(lm, num_slots=2, speculative="draft",
                            draft_bundle=lm, draft_k=3, prefix_cache=False,
                            watchdog_interval=30.0, device="cpu").start()
        try:
            assert eng.generate(p, 8)[5:].tolist() == solo(p, 8)
            a = eng.generate(p, 8, sampling=sps)
            np.testing.assert_array_equal(a, eng.generate(p, 8,
                                                          sampling=sps))
            outs.append(a)
            assert eng.stats()["speculative"]["windows"] > 0
        finally:
            eng.stop()
    np.testing.assert_array_equal(outs[0], outs[1])


def test_spec_sampled_decode_is_pointwise_plain_sampled_decode(lms):
    """Speculative sampled decode emits the plain sampled stream for the
    same (prompt, params), on self-draft and n-gram engines, and JAX's
    plain sampled stream too."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    jlm, lm = lms
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32)
               for n in (3, 5, 7, 9)]
    prompts[3] = np.tile(prompts[3][:3], 3)  # n-gram proposals fire
    params = [dict(temperature=0.8, seed=101), dict(temperature=0.8,
                                                    seed=101),
              dict(temperature=1.1, top_k=7, seed=33),
              dict(temperature=0.7, top_p=0.9, seed=5)]
    kw = dict(num_slots=4, prefix_cache=False, watchdog_interval=30.0)
    jplain = JEngine(jlm, **kw).start()
    engines = [ServingEngine(lm, device="cpu", **kw, **extra).start()
               for extra in ({}, dict(speculative="draft", draft_bundle=lm,
                                      draft_k=3),
                             dict(speculative="ngram", draft_k=3))]
    try:
        for p, s in zip(prompts, params):
            want = jplain.generate(p, 10, sampling=s)
            for eng in engines:
                np.testing.assert_array_equal(
                    eng.generate(p, 10, sampling=s), want)
        assert engines[1].stats()["speculative"]["windows"] > 0
        assert engines[2].stats()["speculative"]["windows"] > 0
    finally:
        jplain.stop()
        for eng in engines:
            eng.stop()


def test_strict_mode_is_the_legacy_refusal(lms, solo):
    _, lm = lms
    with pytest.raises(ValueError, match="GREEDY"):
        ServingEngine(lm, speculative="draft", draft_bundle=lm,
                      spec_mode="strict", temperature=0.5, device="cpu")
    eng = ServingEngine(lm, num_slots=2, speculative="draft",
                        draft_bundle=lm, spec_mode="strict",
                        prefix_cache=False, watchdog_interval=30.0,
                        device="cpu").start()
    try:
        p = _prompt(4, 12)
        assert eng.generate(p, 5)[4:].tolist() == solo(p, 5)
        with pytest.raises(ValueError, match="GREEDY"):
            eng.submit(p, 5, sampling={"temperature": 0.5})
    finally:
        eng.stop()


def test_watchdog_restart_rebuilds_speculative_stepper(lms, solo):
    """A supervisor restart rebuilds the draft and verify machinery (the
    drafter re-bound to the fresh stepper, the verify warmed off the
    serving path): post-restart traffic decodes the solo stream with
    speculation live."""
    _, lm = lms
    prompt = np.arange(1, 6, dtype=np.int32)
    eng = ServingEngine(
        lm, num_slots=2, prefix_cache=False, speculative="draft",
        draft_bundle=lm, draft_k=3, watchdog_interval=0.3,
        watchdog_grace=30.0, max_restarts=3, restart_backoff=0.01,
        device="cpu",
    ).start()
    drafter = eng._stepper.drafter
    old_bank = drafter._st
    plan = FaultPlan().arm("scheduler.loop", times=1, after=2,
                           when=lambda ctx: ctx["busy"])
    try:
        with plan:
            inflight = eng.submit(prompt, 20)
            with pytest.raises(InternalError, match="scheduler crashed"):
                inflight.result(timeout=10)
            _wait(lambda: eng.health()["status"] == "serving"
                  and eng.health()["restarts"] == 1, msg="restart")
            assert eng._stepper.drafter is drafter
            assert drafter._st is not old_bank  # re-bound
            mints = [m["key"] for m in eng.compile_ledger.mints()]
            # the boot engine never warmed; the rebuilt stepper's warmup
            # minted the verify off the serving path
            assert "verify[5]" in mints
            assert eng.generate(prompt, 6)[5:].tolist() == solo(prompt, 6)
            spec = eng.stats()["speculative"]
            assert spec["enabled"] and spec["windows"] > 0
    finally:
        eng.stop()


def test_warmup_mints_verify_then_no_storms(lms):
    """``warmup`` mints the verify (and warms the draft bank) off the
    serving path; after the warm set and ``mark_warmed``, speculative
    traffic mints nothing new: 0 storms."""
    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, speculative="draft",
                        draft_bundle=lm, draft_k=3, prefix_cache=False,
                        device="cpu").start()
    try:
        st = eng._stepper
        st.warmup()
        st.warm_prefill_buckets()
        keys = {m["key"]: m["trigger"] for m in eng.compile_ledger.mints()}
        assert keys["verify[5]"] == "warmup"
        assert keys["step[plain]"] == "warmup"
        assert ("step[plain]", ()) in st.drafter._st._called
        eng.compile_ledger.mark_warmed()
        for n in (5, 9, 17):
            eng.generate(_prompt(n, n), 6)
        snap = eng.compile_ledger.snapshot()
        assert snap["storms"] == 0, snap
        assert eng.stats()["speculative"]["windows"] > 0
    finally:
        eng.stop()


# ------------------------------------------------- SpeculativeGenerator


@pytest.mark.parametrize("k", [1, 3, 5])
def test_speculative_equals_target_greedy_any_draft(lms, drafts, k):
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    jlm, lm = lms
    _, d = drafts
    prompts = np.random.default_rng(16).integers(0, VOCAB, (3, 5)).astype(
        np.int32)
    want = JCached(jlm).generate(prompts, steps=9)
    gen = SpeculativeGenerator(lm, d, k=k, device="cpu")
    got = gen.generate(prompts, steps=9)
    np.testing.assert_array_equal(got, want)
    assert got.dtype == prompts.dtype
    assert gen.last_rounds.shape == (3,) and (gen.last_rounds <= 9).all()


def test_speculative_self_draft_is_the_acceptance_ceiling(lms):
    _, lm = lms
    prompts = np.random.default_rng(17).integers(0, VOCAB, (2, 4)).astype(
        np.int32)
    gen = SpeculativeGenerator(lm, lm, k=3, device="cpu")
    out = gen.generate(prompts, steps=10)
    want = CachedSequenceGenerator(lm, device="cpu").generate(prompts, 10)
    np.testing.assert_array_equal(out, want)
    assert (gen.last_rounds == -(-10 // 4)).all(), gen.last_rounds
    eos = int(want[0, 4])
    trimmed = gen.generate(prompts, steps=10, eos_id=eos)
    assert isinstance(trimmed, list) and trimmed[0].shape == (5,)


def test_speculative_validation(lms):
    _, lm = lms
    with pytest.raises(ValueError, match="k must be"):
        SpeculativeGenerator(lm, lm, k=0, device="cpu")
    other_vocab = zoo.transformer_lm(16, 64, 16, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="vocabulary"):
        SpeculativeGenerator(lm, other_vocab, device="cpu")
    other_seq = zoo.transformer_lm(VOCAB, 16, 16, 2, 1, device="cpu")
    with pytest.raises(ValueError, match="sequence"):
        SpeculativeGenerator(lm, other_seq, device="cpu")
    gen = SpeculativeGenerator(lm, lm, k=2, device="cpu")
    gen.k = 0
    with pytest.raises(ValueError, match="k must be"):
        gen.generate(np.zeros((1, 3), np.int32), 2)


def test_speculative_k_past_budget_and_capacity(lms, drafts):
    _, lm = lms
    _, d = drafts
    ref = CachedSequenceGenerator(lm, device="cpu")
    rng = np.random.default_rng(20)
    short = rng.integers(0, VOCAB, (2, 5)).astype(np.int32)
    for k, steps in [(7, 3), (5, 2), (4, 1)]:
        gen = SpeculativeGenerator(lm, d, k=k, device="cpu")
        np.testing.assert_array_equal(gen.generate(short, steps=steps),
                                      ref.generate(short, steps))
        assert (gen.last_rounds <= steps).all()
    long = rng.integers(0, VOCAB, (2, 60)).astype(np.int32)
    want = ref.generate(long, 4)
    np.testing.assert_array_equal(
        SpeculativeGenerator(lm, d, k=7, device="cpu").generate(long, 4),
        want)
    gen = SpeculativeGenerator(lm, lm, k=7, device="cpu")
    np.testing.assert_array_equal(gen.generate(long, 4), want)
    assert (gen.last_rounds == 1).all(), gen.last_rounds


def test_speculative_eos_mid_draft_window(lms, drafts):
    _, lm = lms
    _, d = drafts
    ref = CachedSequenceGenerator(lm, device="cpu")
    prompts = np.random.default_rng(21).integers(0, VOCAB, (2, 5)).astype(
        np.int32)
    full = ref.generate(prompts, 10)
    for eos_at in (0, 3):
        eos = int(full[0, 5 + eos_at])
        want = ref.generate(prompts, 10, eos_id=eos)
        for dm in (d, lm):
            got = SpeculativeGenerator(lm, dm, k=4, device="cpu").generate(
                prompts, 10, eos_id=eos)
            assert isinstance(got, list)
            for a, b in zip(got, want):
                np.testing.assert_array_equal(a, b)


def test_speculative_k1_degenerates_to_plain_greedy(lms):
    _, lm = lms
    prompts = np.random.default_rng(22).integers(0, VOCAB, (3, 4)).astype(
        np.int32)
    want = CachedSequenceGenerator(lm, device="cpu").generate(prompts, 9)
    gen = SpeculativeGenerator(lm, lm, k=1, device="cpu")
    np.testing.assert_array_equal(gen.generate(prompts, steps=9), want)
    assert (gen.last_rounds == -(-9 // 2)).all(), gen.last_rounds


def test_speculative_generator_rounds_match_jax(lms, drafts):
    """The port's rounds per row equal JAX's ``SpeculativeGenerator``'s on
    the same target, draft and prompts."""
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.predictors import SpeculativeGenerator as JSpec

    jlm, lm = lms
    jd, d = drafts
    prompts = np.random.default_rng(23).integers(0, VOCAB, (2, 6)).astype(
        np.int32)
    want = JSpec(jlm, jd, k=3)
    wout = want.generate(prompts, steps=12)
    got = SpeculativeGenerator(lm, d, k=3, device="cpu")
    np.testing.assert_array_equal(got.generate(prompts, steps=12), wout)
    np.testing.assert_array_equal(got.last_rounds, want.last_rounds)
    del jzoo


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_spec_engine_on_card_matches_solo_and_launch_counts():
    """On the card a self-draft engine with the LayerNorm hook on target
    and draft decodes the solo stream, and one direct window launches
    exactly (2L+1) LayerNorm kernels per verify plus (2L+1) per draft
    step."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = zoo.transformer_lm(**LM)
    draft = zoo.transformer_lm(**LM)
    draft.load_state_dict(lm.state_dict())
    assert attach_fused_layernorm(lm) == 5
    assert attach_fused_layernorm(draft) == 5
    solo = CachedSequenceGenerator(lm)
    prompts = [np.arange(3, 20) % 7, np.arange(5, 11)]
    eng = ServingEngine(lm, num_slots=2, speculative="draft",
                        draft_bundle=draft, draft_k=3).start()
    try:
        for p in prompts:
            np.testing.assert_array_equal(eng.generate(p, 9, timeout=120),
                                          solo.generate(p[None], 9)[0])
    finally:
        eng.stop()
    st = DecodeStepper(lm, num_slots=2, speculative=ModelDrafter(draft),
                       draft_k=3)
    st.warmup()
    st.admit(0, prompts[0])
    st.spec_step(np.array([True, False]))  # admits the draft slot
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    st.spec_step(np.array([True, False]))
    counts = kernels.launch_counts()
    # the verify, then draft_k + 1 = 4 draft steps
    assert counts["layernorm_fwd"] == 5 + 4 * 5
