"""Copy-on-write forks and n > 1 completions in the port, against the JAX
package.

The JAX counterparts: ``tests/test_paged_serving.py``'s fork tests (a fork
matches solo and pays only its divergence, a fork under speculation stays
pinned, fork validation) and ``tests/test_sampling.py``'s completion
groups (completion seeds, n slots reserved together, a group waiting out
pool pressure, a fork failure failing the whole group typed, the n-checks,
n completions over the engine and the wire). Here each holds the port
against JAX on the same weights (bridged with ``params_from_jax``), on the
CPU: tokens equal, page books equal, seeds equal. The scheduler cases run
one scripted drive on JAX's batcher and the port's, in both loop shapes.

The ``gpu``-marked case forks on the card against its CPU run
(``python -m pytest --noconftest tests/test_torch_fork.py -m gpu``).
"""

from __future__ import annotations

import importlib

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.predictors import CachedSequenceGenerator
from distkeras_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeStepper,
    InternalError,
    NgramDrafter,
    PoolExhaustedError,
    ServeRequest,
    ServingEngine,
)
from distkeras_tpu_torch.serving.sampling import (
    SamplingParams,
    seed_for_completion,
)
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
PKG = {"torch": "distkeras_tpu_torch", "jax": "distkeras_tpu"}


def _mod(side, name):
    return importlib.import_module(f"{PKG[side]}.serving.{name}")


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


@pytest.fixture(scope="module")
def solo(lms):
    """``solo(prompt, steps)``: the generated tokens of the port's solo
    greedy decode, held equal to JAX's."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    jlm, lm = lms
    jref, pref = JCached(jlm), CachedSequenceGenerator(lm, device="cpu")

    def run(p, s):
        got = pref.generate(np.asarray(p)[None], s)[0]
        want = jref.generate(np.asarray(p, np.int32)[None], steps=s)[0]
        np.testing.assert_array_equal(got, want)
        return got[len(p):].tolist()

    return run


def _stepper(side, lm, **kw):
    if side == "jax":
        from distkeras_tpu.serving.engine import DecodeStepper as JStepper

        return JStepper(lm, **kw)
    return DecodeStepper(lm, device="cpu", **kw)


def _decode(st, slots, steps):
    active = np.zeros(st.num_slots, bool)
    active[list(slots)] = True
    out = {s: [] for s in slots}
    for _ in range(steps):
        t = st.step(active)
        for s in slots:
            out[s].append(int(t[s]))
    return out


def test_completion_seeds_match_jax():
    """``seed_for_completion`` for completions 0..7 of several seeds is
    JAX's; completion 0 keeps the request seed; the 8 seeds are distinct."""
    jsp = _mod("jax", "sampling")
    for seed in (0, 7, 41, 150, (1 << 31) - 1, 1 << 40):
        got = [seed_for_completion(seed, j) for j in range(8)]
        assert got == [jsp.seed_for_completion(seed, j) for j in range(8)]
        assert got[0] == seed % (1 << 31) and len(set(got)) == 8


@pytest.mark.parametrize("plen", [7, 9], ids=["partial_page",
                                              "full_page"])
def test_fork_matches_solo_and_pays_only_divergence(lms, solo, plen):
    """A CoW fork mid-decode: the fork and its source both continue their
    solo decode, the fork shares every full page below the frontier and
    copies at most the one partial page — the same tables, page books and
    tokens as JAX's stepper given the same calls. Prompt 9 + 4 steps puts
    the frontier on a page boundary (no copy); 7 + 4 does not."""
    jlm, lm = lms
    prompt = np.random.default_rng(10).integers(0, 61, plen).astype(np.int32)
    full = solo(prompt, 9)
    rec = {}
    for side, model in (("jax", jlm), ("torch", lm)):
        st = _stepper(side, model, num_slots=3, paged=True, page_size=4,
                      prefix_cache=None)
        st.admit(0, prompt, max_new=12)
        got = _decode(st, [0], 4)[0]
        before = st._kv_alloc.pages_in_use
        st.fork_slot(0, 2, max_new=8)
        ln = plen + 4
        frontier = (ln - 1) // 4
        books = dict(shared=st._kv_alloc.shared_pages,
                     cow=st._kv_alloc.cow_copies,
                     fresh=st._kv_alloc.pages_in_use - before,
                     tables=[list(t) for t in st._tables],
                     lens=[int(x) for x in st._lens])
        assert books["shared"] >= frontier
        assert books["cow"] == (1 if (ln - 1) % 4 else 0)
        assert books["fresh"] <= st.pages_for(ln, 8) - frontier
        after = _decode(st, [0, 2], 5)
        assert got + after[0] == full
        assert after[2] == full[4:]
        st.release(0)
        st.release(2)
        st.prefix_index.clear()
        assert st._kv_alloc.pages_in_use == 0
        rec[side] = (books, after)
    assert rec["torch"] == rec["jax"]


def test_fork_copies_sampler_state_under_the_derived_seed(lms):
    """A sampled fork: dst copies src's params and emitted-position
    counter and samples under ``seed_for_completion(seed, 2)`` — the
    tokens JAX's fork samples, and what an independent admission with that
    seed samples from the same point."""
    jlm, lm = lms
    prompt = np.random.default_rng(4).integers(0, 61, 10).astype(np.int32)
    rec = {}
    for side, model in (("jax", jlm), ("torch", lm)):
        sp = _mod(side, "sampling").SamplingParams(temperature=0.9, seed=41)
        st = _stepper(side, model, num_slots=3, paged=True, page_size=4)
        st.admit(0, prompt, max_new=12, sampling=sp)
        st.fork_slot(0, 1, max_new=12, completion=2)
        assert int(st._seeds[1]) == seed_for_completion(41, 2)
        assert int(st._spos[1]) == int(st._spos[0]) == 0
        rec[side] = _decode(st, [0, 1], 6)
    assert rec["torch"] == rec["jax"]
    # completion 2 = a fresh admission under the derived seed
    st = _stepper("torch", lm, num_slots=1, paged=True, page_size=4)
    st.admit(0, prompt, max_new=12, sampling=SamplingParams(
        temperature=0.9, seed=seed_for_completion(41, 2)))
    assert _decode(st, [0], 6)[0] == rec["torch"][1]


def test_fork_under_speculation_stays_pinned(lms, solo):
    """Forking a slot on a SPECULATIVE stepper: the fork is marked
    draft-admitted and invalid (the draft bank holds no K/V for what the
    source decoded), and both streams stay their solo decode."""
    _, lm = lms
    st = DecodeStepper(lm, num_slots=3, paged=True, page_size=4,
                       speculative=NgramDrafter(), draft_k=3,
                       prefix_cache=None, device="cpu")
    p = ((5 + np.arange(11)) % 9).astype(np.int32)  # repetitive
    full = solo(p, 9)
    st.admit(0, p, max_new=12)
    outs = {0: []}

    def advance(live):
        active = np.zeros(3, bool)
        active[list(live)] = True
        seqs = [(p, outs[i]) if i in live else None for i in range(3)]
        toks, counts, _ = st.spec_step(active, seqs)
        for i in live:
            outs[i].extend(int(t) for t in
                           np.atleast_1d(toks[i])[: int(counts[i])])

    while len(outs[0]) < 4:
        advance([0])
    outs[0] = outs[0][:4]
    st._lens[0] = p.size + 4  # trim any window tail past the cut
    st.fork_slot(0, 2, max_new=8)
    assert 2 in st._spec_admitted  # no lazy junk-draft admission later
    outs[2] = list(outs[0])
    while len(outs[0]) < 9 or len(outs[2]) < 9:
        advance([i for i in (0, 2) if len(outs[i]) < 9])
    assert outs[0][:9] == full
    assert outs[2][:9] == full


def test_fork_validation(lms):
    """JAX's refusals: a dense stepper, a source that is not decodable, a
    destination that holds pages; a fork the pool cannot cover raises
    ``PoolExhaustedError`` with nothing changed."""
    _, lm = lms
    st = DecodeStepper(lm, num_slots=2, paged=True, page_size=4,
                       device="cpu")
    with pytest.raises(ValueError, match="not a decodable"):
        st.fork_slot(0, 1)
    dense = DecodeStepper(lm, num_slots=2, device="cpu")
    assert dense.can_fork is False and st.can_fork is True
    with pytest.raises(ValueError, match="paged"):
        dense.fork_slot(0, 1)
    st.admit(0, np.arange(1, 8), max_new=4)
    st.admit(1, np.arange(1, 4), max_new=4)
    with pytest.raises(ValueError, match="already holds pages"):
        st.fork_slot(0, 1)
    tight = DecodeStepper(lm, num_slots=2, paged=True, page_size=4,
                          num_pages=5, prefix_cache=None, device="cpu")
    tight.admit(0, np.arange(1, 11), max_new=2)  # 3 of the 4 real pages
    tight.prefix_index.clear()
    def books():
        alloc = tight._kv_alloc.stats()
        return ({k: v for k, v in alloc.items() if k != "exhaustions"},
                [list(t) for t in tight._tables], tight._lens.tolist(),
                tight._ctx.clone())

    before = books()
    with pytest.raises(PoolExhaustedError):
        tight.fork_slot(0, 1, max_new=12)
    after = books()
    assert after[:3] == before[:3] and torch.equal(after[3], before[3])
    assert tight._kv_alloc.stats()["exhaustions"] == 1  # counted, typed


def test_fork_pages_for_matches_jax(lms):
    jlm, lm = lms
    for kw in ({}, {"speculative": None}):
        sj = _stepper("jax", jlm, num_slots=2, paged=True, page_size=4, **kw)
        spt = _stepper("torch", lm, num_slots=2, paged=True, page_size=4,
                       **kw)
        for plen, mnew in ((1, 3), (4, 4), (7, 9), (10, 12), (20, 12)):
            assert spt.fork_pages_for(plen, mnew) == sj.fork_pages_for(
                plen, mnew)


# -------------------------------------------- completion groups (scheduler)


class FakeForkStepper:
    """JAX's fake of a fork-capable stepper: slot i's n-th token is
    ``100 * (i + 1) + n``; forks are recorded, and ``pressure`` fork calls
    raise ``PoolExhaustedError`` first."""

    can_fork = True
    speculative = False
    wants_sequences = False

    def __init__(self, exc_mod, num_slots=4, max_len=32, fail_fork=False,
                 pressure=0):
        self.num_slots, self.max_len = num_slots, max_len
        self.fail_fork, self.pressure = fail_fork, pressure
        self._exc = exc_mod.PoolExhaustedError
        self._n = np.zeros(num_slots, int)
        self.forked, self.released, self.admitted = [], [], []

    def begin_admit(self, slot, prompt, **kw):
        self.admitted.append(slot)
        self._n[slot] = 0
        return 0

    def prefill_chunk(self, slot, budget):
        return 0

    def fork_slot(self, src, dst, max_new=None, completion=1):
        if self.pressure > 0:
            self.pressure -= 1
            raise self._exc("raced away")
        if self.fail_fork:
            raise RuntimeError("fork exploded")
        self.forked.append((src, dst, completion))

    def release(self, slot):
        self.released.append(slot)

    def step(self, active):
        toks = np.full(self.num_slots, -1)
        for i in np.flatnonzero(active):
            toks[i] = 100 * (i + 1) + self._n[i]
            self._n[i] += 1
        return toks


def _group_drive(side, case, overlap):
    sched = _mod(side, "scheduler")
    sp = _mod(side, "sampling").SamplingParams
    kw = {"fail_fork": case == "fork_failure",
          "pressure": 2 if case == "pool_pressure" else 0}
    st = FakeForkStepper(sched, num_slots=4, **kw)
    b = sched.ContinuousBatcher(st, queue_capacity=8, overlap=overlap)
    n = 3 if case == "reserve_and_complete" else 2
    req = b.submit(sched.ServeRequest(
        [1, 2], 3, sampling=sp(temperature=0.5, n=n)))
    single = b.submit(sched.ServeRequest([9], 3))
    for _ in range(20):
        b.step()
        if req.done and single.done:
            break
    assert req.done and single.done
    nxt = b.submit(sched.ServeRequest([3], 2))
    for _ in range(10):
        b.step()
        if nxt.done:
            break
    try:
        outs = [o.tolist() for o in req.result(0)]
    except Exception as e:  # noqa: BLE001 — recorded and compared
        outs = (type(e).__name__, "fork exploded" in str(e))
    s = b.stats()
    return {
        "outs": outs, "single": single.result(0).tolist(),
        "next": nxt.result(0).tolist(), "forked": st.forked,
        "admitted": st.admitted, "released": sorted(st.released),
        "books": {k: s[k] for k in ("completed", "prefill_failures",
                                    "internal_errors", "forked_slots",
                                    "sampled_requests", "tokens_generated")},
        "idle": b.idle,
    }


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlapped"])
@pytest.mark.parametrize("case", ["reserve_and_complete", "pool_pressure",
                                  "fork_failure"])
def test_group_scheduling_matches_jax(case, overlap):
    """A group takes its n slots together and forks before its primary
    emits; a fork racing pool exhaustion WAITS (a retry, never a failure);
    any other fork failure fails the whole group typed and frees every
    slot. The port's batcher records what JAX's does, in the same loop
    shape."""
    got = _group_drive("torch", case, overlap)
    assert got == _group_drive("jax", case, overlap)
    assert got["idle"]
    if case == "reserve_and_complete":
        assert len(got["outs"]) == 3 and got["books"]["forked_slots"] == 2
        assert {c for _, _, c in got["forked"]} == {1, 2}
        assert got["books"]["completed"] == 3  # one per REQUEST
        assert got["books"]["sampled_requests"] == 1
    elif case == "pool_pressure":
        assert len(got["outs"]) == 2 and got["books"]["forked_slots"] == 1
        assert got["books"]["prefill_failures"] == 0  # a wait
    else:
        assert got["outs"] == ("InternalError", True)


def test_group_n_checks():
    """JAX's refusals at ``submit``: more completions than slots, a
    stepper that cannot fork, a streamed group — with JAX's messages."""
    jsched = _mod("jax", "scheduler")
    jsp = _mod("jax", "sampling").SamplingParams
    cases = [
        ("exceed", 2, dict(n=3), {}),
        ("fork", 4, dict(n=2), {"can_fork": False}),
        ("streamed", 4, dict(n=2), {"stream": True}),
    ]
    for match, slots, spk, extra in cases:
        msgs = []
        for mod, sp in ((jsched, jsp), (_mod("torch", "scheduler"),
                                        SamplingParams)):
            st = FakeForkStepper(mod, num_slots=slots)
            if "can_fork" in extra:
                st.can_fork = extra["can_fork"]
            b = mod.ContinuousBatcher(st, queue_capacity=8)
            r = mod.ServeRequest([1], 2, sampling=sp(temperature=0.5, **spk),
                                 stream=extra.get("stream", False))
            with pytest.raises(ValueError, match=match) as ei:
                b.submit(r)
            msgs.append(str(ei.value))
        assert msgs[0] == msgs[1]


def test_dense_engine_refuses_n_with_jax_error(lms):
    jlm, lm = lms
    from distkeras_tpu.serving import ServingEngine as JEngine

    msgs = []
    for eng in (JEngine(jlm, num_slots=4, watchdog_interval=30.0),
                ServingEngine(lm, num_slots=4, watchdog_interval=30.0,
                              device="cpu")):
        eng.start()
        try:
            with pytest.raises(ValueError, match="paged=True") as ei:
                eng.submit(np.arange(1, 5), 3, sampling={
                    "temperature": 0.5, "n": 2})
            msgs.append(str(ei.value))
        finally:
            eng.stop()
    assert msgs[0] == msgs[1]


def _engine(side, lm, overlap=True, **kw):
    if side == "jax":
        from distkeras_tpu.serving import ServingEngine as JEngine

        return JEngine(lm, overlap=overlap, watchdog_interval=30.0, **kw)
    return ServingEngine(lm, overlap=overlap, watchdog_interval=30.0,
                         device="cpu", **kw)


@pytest.mark.parametrize("overlap", [False, True],
                         ids=["sequential", "overlapped"])
def test_n_completions_match_jax_engine(lms, overlap):
    """THE fork pin: n = 3 through the port's paged engine returns JAX's
    engine's three sequences for the same seed (prompt 10 on pages of 4:
    a partial frontier page, one CoW copy per fork), completion j equals
    an independent admission under ``seed_for_completion(seed, j)`` and
    completion 0 the n = 1 request; a group's peak pages are fewer than n
    independent reservations."""
    jlm, lm = lms
    p = np.random.default_rng(15).integers(0, 61, 10).astype(np.int32)
    res = {}
    for side, model in (("jax", jlm), ("torch", lm)):
        sp = _mod(side, "sampling").SamplingParams
        eng = _engine(side, model, overlap=overlap, num_slots=4, paged=True,
                      page_size=4, prefix_cache=False).start()
        try:
            group = eng.generate(p, 6, sampling=sp(temperature=0.9, seed=41,
                                                   n=3))
            singles = [eng.generate(p, 6, sampling=sp(
                temperature=0.9, seed=seed_for_completion(41, j)))
                for j in range(3)]
            one = eng.generate(p, 6, sampling=sp(temperature=0.9, seed=41))
            st = eng.stats()
        finally:
            eng.stop()
        assert isinstance(group, list) and len(group) == 3
        for g, s in zip(group, singles):
            np.testing.assert_array_equal(g, s)
        np.testing.assert_array_equal(group[0], one)
        res[side] = ([g.tolist() for g in group], st["forked_slots"],
                     st["paged"]["cow_copies"])
    assert res["torch"] == res["jax"]
    assert res["torch"][1] == 2 and res["torch"][2] == 2


def test_group_peak_pages_below_n_reservations(lms):
    """A group's forks share the prompt's history pages: its peak pages in
    use stay below n independent reservations."""
    from distkeras_tpu_torch.faults import FaultPlan

    _, lm = lms
    p = np.random.default_rng(2).integers(0, 61, 17).astype(np.int32)
    eng = ServingEngine(lm, num_slots=4, paged=True, page_size=4,
                        prefix_cache=False, watchdog_interval=30.0,
                        device="cpu").start()
    peak = [0]

    def note(ctx):
        peak[0] = max(peak[0], eng._stepper._kv_alloc.pages_in_use)
        return False

    try:
        with FaultPlan().arm("stepper.step", times=None, when=note):
            outs = eng.generate(p, 8, sampling=SamplingParams(
                temperature=0.8, seed=5, n=4))
        per = eng._stepper.pages_for(17, 8)
    finally:
        eng.stop()
    assert len(outs) == 4
    assert peak[0] < 4 * per
    assert peak[0] <= per + 3 * eng._stepper.fork_pages_for(17, 8)


@pytest.mark.parametrize("pair", ["torch-torch", "jax-client", "jax-server"])
def test_n_reply_over_the_wire(lms, pair):
    """``n = 3`` through a ``ServingServer``: the reply carries ``n`` and
    the list of sequences, equal to the in-process ones — port server and
    client, a JAX client against the port's server, and the port's client
    against a JAX server."""
    jlm, lm = lms
    from distkeras_tpu.serving import ServingClient as JClient
    from distkeras_tpu.serving import ServingServer as JServer

    from distkeras_tpu_torch.serving import ServingClient, ServingServer

    server_side = "jax" if pair == "jax-server" else "torch"
    model = jlm if server_side == "jax" else lm
    eng = _engine(server_side, model, num_slots=4, paged=True, page_size=4,
                  prefix_cache=False).start()
    srv = (JServer if server_side == "jax" else ServingServer)(eng).start()
    client_cls = JClient if pair == "jax-client" else ServingClient
    p = np.random.default_rng(3).integers(0, 61, 7).astype(np.int32)
    try:
        sp = _mod(server_side, "sampling").SamplingParams
        want = eng.generate(p, 5, sampling=sp(temperature=0.8, seed=9, n=3))
        with client_cls("127.0.0.1", srv.port) as c:
            got = c.generate(p, 5, sampling={"temperature": 0.8, "seed": 9,
                                             "n": 3})
    finally:
        srv.shutdown()
        eng.stop()
    assert isinstance(got, list) and len(got) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.gpu
def test_fork_on_card_equals_cpu_run():
    """A sampled paged fork on the card: the same tokens as the same
    weights' CPU fork, one CoW copy, and the fork runs with a step in
    flight without synchronizing the stream once its programs are warm."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    cpu = zoo.transformer_lm(**LM, device="cpu")
    lm = cpu.copy().to("cuda")
    prompt = np.random.default_rng(4).integers(0, 61, 10)
    sp = SamplingParams(temperature=0.9, seed=41)
    outs = {}
    for name, model, dev in (("cpu", cpu, "cpu"), ("cuda", lm, None)):
        st = DecodeStepper(model, num_slots=3, paged=True, page_size=4,
                           device=dev)
        st.warmup()
        st.warm_restore_buckets()
        st.admit(0, prompt, max_new=12, sampling=sp)
        st.admit(2, prompt[:5], max_new=4)
        if dev is None:
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            h = st.step_async(np.array([False, False, True]))
            st.fork_slot(0, 1, max_new=12, completion=1)
        finally:
            if dev is None:
                torch.cuda.set_sync_debug_mode(0)
        h.collect()
        assert st._kv_alloc.cow_copies == 1
        outs[name] = _decode(st, [0, 1], 6)
    assert outs["cuda"] == outs["cpu"]
