"""The port's paged KV cache and prefix cache against the JAX package.

THE bar, inherited from the JAX package's ``tests/test_paged_serving.py``:
a slot's greedy stream equals its solo ``CachedSequenceGenerator`` decode
(the port's and JAX's) token for token on every admission path — fresh,
chunked, device-prefix hit, host-ladder hit (dense and paged), a failing
prefix fetch — whatever the neighbouring slots do. Beside it: the port's
paged stepper holds the same page tables and emits the same tokens as
JAX's paged stepper given the same admissions, its pools hold JAX's K/V
rows, and the capacity semantics (reservation, typed exhaustion before
any slot state, page-gated admission, pages freed on quarantine, a
restart that rebuilds the pool and keeps the host store).

All on the CPU, on JAX's small LM (vocab 61, seq 32, d32, 2 heads, depth
2) with its weights carried into the port. The JAX package is imported
inside the fixtures and tests, so the ``gpu``-marked cases also run on a
machine without JAX (``python -m pytest --noconftest
tests/test_torch_paged_serving.py -m gpu``).
"""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import faults
from distkeras_tpu_torch.faults import FaultPlan
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.predictors import CachedSequenceGenerator
from distkeras_tpu_torch.serving import (
    ContinuousBatcher,
    DecodeStepper,
    InternalError,
    PoolExhaustedError,
    PrefixStore,
    ServeRequest,
    ServingClient,
    ServingEngine,
    ServingError,
    ServingServer,
)
from distkeras_tpu_torch.networking import RetryPolicy
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)


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
def solo(lms):
    """``solo(prompt, steps)``: the generated tokens of the port's solo
    decode, held equal to JAX's."""
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


def _paged(lm, **kw):
    kw.setdefault("num_slots", 3)
    kw.setdefault("page_size", 4)
    return DecodeStepper(lm, paged=True, device="cpu", **kw)


def _decode_slot(st, slot, steps):
    out = []
    for _ in range(steps):
        active = np.zeros(st.num_slots, bool)
        active[slot] = True
        out.append(int(st.step(active)[slot]))
    return out


def _wait(cond, timeout=30.0, msg="condition"):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return
        time.sleep(0.01)
    raise AssertionError(f"timed out waiting for {msg}")


def _churn(st, prompts, steps, admit_at, on_admit=None, on_step=None):
    """JAX's churn drive: slots admitted at different iterations with
    different prompt lengths, evicted and reused. Returns each request's
    tokens."""
    serving, outs = {}, [[] for _ in prompts]
    st.admit(0, prompts[0], max_new=steps[0])
    serving[0] = 0
    if on_admit:
        on_admit(st, 0)
    next_req = max(admit_at.values()) + 1
    for i in range(60):
        ri = admit_at.get(i)
        if ri is not None:
            st.admit(ri, prompts[ri], max_new=steps[ri])
            serving[ri] = ri
            if on_admit:
                on_admit(st, ri)
        if not serving:
            break
        active = np.zeros(st.num_slots, bool)
        active[list(serving)] = True
        if on_step:
            on_step(st, active)
        toks = st.step(active)
        for slot, ri in list(serving.items()):
            outs[ri].append(int(toks[slot]))
            if len(outs[ri]) == steps[ri]:
                del serving[slot]
                st.release(slot)
                if next_req < len(prompts):
                    st.admit(slot, prompts[next_req],
                             max_new=steps[next_req])
                    serving[slot] = next_req
                    if on_admit:
                        on_admit(st, slot)
                    next_req += 1
    return outs


# ---------------------------------------------------- parity with JAX


def test_paged_stepper_matches_jax_tables_and_tokens_with_churn(lms, solo):
    """The same admissions with churn through JAX's paged stepper and the
    port's: equal page tables after every admission, equal tokens every
    step, equal pool books — and every stream equals solo decode."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    rng = np.random.default_rng(0)
    prompts = [rng.integers(0, 61, n).astype(np.int32)
               for n in (5, 1, 9, 3, 14, 7)]
    steps = [8, 8, 6, 5, 9, 4]
    admit_at = {2: 1, 4: 2}
    records = {}
    for name, st in (
        ("jax", JStepper(jlm, num_slots=3, paged=True, page_size=4)),
        ("torch", _paged(lm)),
    ):
        rec = {"tables": [], "steps": []}
        outs = _churn(
            st, prompts, steps, admit_at,
            on_admit=lambda s, slot: rec["tables"].append(
                [list(t) for t in s._tables]),
            on_step=lambda s, a: rec["steps"].append(a.tolist()),
        )
        rec["outs"] = outs
        rec["alloc"] = st._kv_alloc.stats()
        rec["index"] = st.prefix_index.stats()
        records[name] = rec
    assert records["torch"] == records["jax"]
    for p, s, o in zip(prompts, steps, records["torch"]["outs"]):
        assert o == solo(p, s)


def test_paged_pool_rows_match_jax(lms):
    """A slot's K/V gathered from the port's pools equals JAX's within
    1e-5 at every written position, after chunked prefill, a device-prefix
    hit and decode steps."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    rng = np.random.default_rng(21)
    header = rng.integers(0, 61, 13).astype(np.int32)
    a = np.concatenate([header, rng.integers(0, 61, 6).astype(np.int32)])
    b = np.concatenate([header, rng.integers(0, 61, 3).astype(np.int32)])
    sts = {"jax": JStepper(jlm, num_slots=2, paged=True, page_size=4),
           "torch": _paged(lm, num_slots=2)}
    for st in sts.values():
        left = st.begin_admit(0, a, max_new=6)
        while left:
            left = st.prefill_chunk(0, 5)
        st.admit(1, b, max_new=6)  # hits a's 3 full header pages
        for _ in range(4):
            st.step(np.array([True, True]))
    assert sts["torch"]._tables == sts["jax"]._tables
    assert sts["torch"].prefix_index.stats()["hits"] == 1
    for slot in (0, 1):
        table = sts["torch"]._tables[slot]
        n = int(sts["torch"]._lens[slot]) - 1  # positions written so far
        for (jk, jv), (pk, pv) in zip(sts["jax"]._pools,
                                      sts["torch"]._pools):
            for jarr, parr in ((jk, pk), (jv, pv)):
                want = np.asarray(jarr)[table].reshape(-1, 2, 16)[:n]
                got = parr[table].reshape(-1, 2, 16)[:n].numpy()
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


# ------------------------------------------- identity: every admission path


def test_paged_chunked_prefill_matches_solo(lms, solo):
    _, lm = lms
    st = _paged(lm, num_slots=2)
    rng = np.random.default_rng(7)
    prompt = rng.integers(0, 61, 23).astype(np.int32)
    left = st.begin_admit(0, prompt, max_new=7)
    assert left == 22
    sizes = []
    while left:
        before = left
        left = st.prefill_chunk(0, 5)
        sizes.append(before - left)
    assert sizes == [5, 5, 5, 5, 2]  # the budget respected
    # chunk keys stay pow2 on both axes (chunk, table bucket)
    assert all(c & (c - 1) == 0 and t & (t - 1) == 0
               for c, t in st.paged_stats()["compiled_chunk_buckets"])
    assert _decode_slot(st, 0, 7) == solo(prompt, 7)


def test_paged_chunk_shrinks_at_table_capacity(lms, solo):
    """A prompt prefilling up against its RESERVED pages shrinks its tail
    chunk to a pow2 that fits, so no write leaves the slot's pages."""
    _, lm = lms
    st = _paged(lm, num_slots=1)
    rng = np.random.default_rng(11)
    prompt = rng.integers(0, 61, 31).astype(np.int32)
    left = st.begin_admit(0, prompt, max_new=1)
    assert len(st._tables[0]) == 8  # 32 positions at page_size 4
    while left:
        left = st.prefill_chunk(0, 5)
    keys = st.paged_stats()["compiled_chunk_buckets"]
    assert keys and all(c <= 8 for c, _ in keys)
    assert _decode_slot(st, 0, 1) == solo(prompt, 1)


def test_paged_device_prefix_hit_is_shared_not_copied(lms, solo):
    """Two prompts sharing a header: the second SHARES the header's full
    pages (refcount, zero transfers: no host store here) and decodes
    token-identical to solo."""
    _, lm = lms
    st = _paged(lm)
    rng = np.random.default_rng(8)
    header = rng.integers(0, 61, 17).astype(np.int32)
    st.admit(0, header, max_new=6)
    assert _decode_slot(st, 0, 6) == solo(header, 6)
    ext = np.concatenate([header, rng.integers(0, 61, 5).astype(np.int32)])
    in_use = st._kv_alloc.pages_in_use
    left = st.begin_admit(1, ext, max_new=6)
    # the 17-token prompt registered 4 full pages (16 positions)
    assert st.prefix_index.stats()["hits"] == 1
    assert st.prefix_index.stats()["hit_pages"] == 4
    assert left == (ext.size - 1) - 16
    assert st._tables[1][:4] == st._tables[0][:4]
    assert st._kv_alloc.shared_pages >= 4
    # only the private tail was allocated
    assert (st._kv_alloc.pages_in_use - in_use
            == st.pages_for(ext.size, 6) - 4)
    while left:
        left = st.prefill_chunk(1, 4)
    assert _decode_slot(st, 1, 6) == solo(ext, 6)
    st.release(0)
    assert _decode_slot(st, 1, 2) == solo(ext, 8)[6:]


def test_paged_host_ladder_hit_matches_solo(lms, solo):
    """With the device index cleared, the host ``PrefixStore`` ladder
    restores into private pages, token-identical to solo."""
    _, lm = lms
    store = PrefixStore(max_bytes=8 << 20)
    st = _paged(lm, num_slots=2, prefix_cache=store)
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 61, 17).astype(np.int32)
    for _ in range(2):  # miss 1 (ghost), miss 2 (the ladder is stored)
        st.admit(0, prompt, max_new=6)
        st.release(0)
        st.prefix_index.clear()
    assert store.stats()["entries"] >= 1
    assert st._kv_alloc.pages_in_use == 0
    left = st.begin_admit(1, prompt, max_new=6)
    assert store.stats()["hits"] == 1
    assert store.stats()["hit_tokens"] == 16
    assert left == prompt.size - 1 - 16  # the rung skipped real prefill
    # a restore writes into freshly allocated private pages
    assert st.prefix_index.stats()["hits"] == 0
    assert st._kv_alloc.pages_in_use == st.pages_for(prompt.size, 6)
    while left:
        left = st.prefill_chunk(1, 4)
    assert _decode_slot(st, 1, 6) == solo(prompt, 6)
    assert "paged_restore[16,8]" in {k for k, _ in st._called}


def test_dense_host_ladder_hit_matches_solo(lms, solo):
    """The dense bank's prefix cache: the third admission of a prompt
    restores the 16-position rung (bucketed copy, ``restore`` key) and
    decodes token-identical to solo; a 24-position prompt that shares the
    header reuses the same rung."""
    _, lm = lms
    store = PrefixStore(max_bytes=8 << 20)
    st = DecodeStepper(lm, num_slots=2, prefix_cache=store, device="cpu")
    rng = np.random.default_rng(19)
    prompt = rng.integers(0, 61, 21).astype(np.int32)
    outs = []
    for _ in range(3):
        left = st.begin_admit(0, prompt)
        while left:
            left = st.prefill_chunk(0, 8)
        outs.append(_decode_slot(st, 0, 6))
        st.release(0)
    assert store.stats()["hits"] == 1 and store.stats()["inserts"] == 2
    assert outs == [solo(prompt, 6)] * 3
    other = np.concatenate([prompt[:16],
                            rng.integers(0, 61, 8).astype(np.int32)])
    assert st.begin_admit(1, other) == other.size - 1 - 16
    st.prefill_chunk(1, 64)
    assert _decode_slot(st, 1, 5) == solo(other, 5)
    restores = [(k, sig) for k, sig in st._called if k == "restore"]
    assert len(restores) == 1 and restores[0][1][2] == 16


@pytest.mark.parametrize("paged", [False, True])
def test_prefix_fetch_failure_degrades_to_miss(lms, solo, paged):
    """A broken prefix store costs correctness nothing: failing lookups
    degrade to misses, the prefill recomputes everything and the output
    equals solo decode."""
    _, lm = lms
    store = PrefixStore(max_bytes=8 << 20)
    st = DecodeStepper(lm, num_slots=1, prefix_cache=store, paged=paged,
                       page_size=4, device="cpu")
    rng = np.random.default_rng(9)
    prompt = rng.integers(0, 61, 17).astype(np.int32)
    want = solo(prompt, 5)
    plan = FaultPlan().arm("prefix_cache.fetch", times=None)
    with plan:
        for _ in range(3):  # traffic that would otherwise insert and hit
            st.admit(0, prompt, max_new=5)
            assert _decode_slot(st, 0, 5) == want
            st.release(0)
            if paged:
                st.prefix_index.clear()
    assert st.prefix_fetch_failures >= 3
    assert plan.fired("prefix_cache.fetch") >= 3
    assert store.stats()["hits"] == 0


# ------------------------------------------------- capacity semantics


def test_exhaustion_before_any_slot_state(lms):
    _, lm = lms
    st = _paged(lm, num_slots=2, num_pages=3)
    rng = np.random.default_rng(1)
    st.set_sampling(0, None)
    temps = st._temps.copy()
    with pytest.raises(PoolExhaustedError) as ei:
        st.begin_admit(0, rng.integers(0, 61, 20).astype(np.int32),
                       max_new=8,
                       sampling=SamplingParams(temperature=0.7, seed=3))
    assert ei.value.code == "overloaded" and ei.value.retry_after_ms > 0
    # nothing to roll back: no table, no pending admission, empty pool,
    # the sampler state untouched
    assert st._tables[0] == [] and 0 not in st._pending
    assert st._kv_alloc.pages_in_use == 0
    np.testing.assert_array_equal(st._temps, temps)
    st.admit(0, rng.integers(0, 61, 4).astype(np.int32), max_new=3)
    assert st._kv_alloc.pages_in_use > 0


def test_never_fits_pool_is_value_error(lms):
    _, lm = lms
    st = _paged(lm, num_slots=2, num_pages=4)
    b = ContinuousBatcher(st, queue_capacity=4)
    with pytest.raises(ValueError, match="KV pages"):
        b.submit(ServeRequest(np.arange(1, 12, dtype=np.int32), 12))
    assert b.submit(ServeRequest(np.arange(1, 6, dtype=np.int32), 4))


def test_pool_gates_admission_but_everyone_completes(lms, solo):
    """More demand than the pool covers: the scheduler admits only what
    fits (the head of the queue waits for evictions); nothing fails,
    nothing hangs, outputs stay pinned."""
    _, lm = lms
    eng = ServingEngine(
        lm, num_slots=4, paged=True, page_size=4, num_pages=13,
        prefill_chunk=8, queue_capacity=16, prefix_cache=False,
        watchdog_interval=30.0, device="cpu",
    ).start()
    peak = []
    try:
        rng = np.random.default_rng(2)
        reqs = [
            (rng.integers(0, 61, int(rng.integers(3, 16))).astype(np.int32),
             int(rng.integers(2, 6)))
            for _ in range(8)
        ]
        def note_pool(ctx):
            # a seam that never fires: it reads the pool at every step
            peak.append(eng._stepper._kv_alloc.pages_in_use)
            return False

        plan = FaultPlan().arm("stepper.step", times=None, when=note_pool)
        with plan:
            handles = [eng.submit(p, s) for p, s in reqs]
            outs = [h.result(120) for h in handles]
        for (p, s), o in zip(reqs, outs):
            assert o[len(p):].tolist() == solo(p, s)
        st = eng.stats()
        assert st["completed"] == len(reqs)
        assert st["internal_errors"] == 0
        assert st["paged"]["exhaustions"] == 0  # gating did its job
        assert peak and max(peak) <= 12
    finally:
        eng.stop()


def test_pool_exhausted_fails_one_admission_typed_over_the_wire(lms, solo):
    """An armed ``kv.alloc`` seam fails the one admission it hits: the wire
    reply is ``overloaded`` with ``retry_after_ms``, a retrying client gets
    the reply on its retry, and the requests beside it are unaffected."""
    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, paged=True, page_size=4,
                        watchdog_interval=30.0, device="cpu")
    srv = ServingServer(eng).start()
    p = np.arange(3, 12, dtype=np.int32)
    q = np.arange(20, 26, dtype=np.int32)
    try:
        with ServingClient(srv.host, srv.port, timeout=60, retry=False,
                           connect_timeout=2) as c:
            with FaultPlan().arm(
                "kv.alloc", exc=PoolExhaustedError("injected",
                                                   retry_after_ms=7.0),
                times=1,
            ):
                with pytest.raises(ServingError) as ei:
                    c.generate(p, 5)
            assert ei.value.code == "overloaded"
            assert ei.value.retry_after == pytest.approx(0.007)
            assert c.generate(q, 4)[len(q):].tolist() == solo(q, 4)
        with ServingClient(
            srv.host, srv.port, timeout=60, connect_timeout=2,
            retry=RetryPolicy(max_attempts=3, base_delay=0.01, seed=0),
        ) as c:
            with FaultPlan().arm(
                "kv.alloc", exc=PoolExhaustedError("injected"), times=1,
            ) as plan:
                out = c.generate(p, 5)
            assert plan.fired("kv.alloc") == 1
            assert out[len(p):].tolist() == solo(p, 5)
        st = eng.stats()
        assert st["prefill_failures"] == 2 and st["internal_errors"] == 0
        assert st["paged"]["exhaustions"] == 0  # injected, not organic
    finally:
        srv.shutdown()


def test_engine_health_gauges_and_stats_expose_pool(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, paged=True, page_size=4,
                        watchdog_interval=30.0, device="cpu").start()
    try:
        eng.generate(np.arange(1, 6, dtype=np.int32), 3)
        h = eng.health()
        assert 0.0 < h["kv_page_util"] <= 1.0  # the index holds a page
        samples = {s["name"]: s for s in eng.metrics_snapshot()}
        for name in ("serving_kv_pages_total", "serving_kv_pages_in_use",
                     "serving_kv_pages_shared", "serving_kv_cow_copies",
                     "serving_kv_page_util",
                     "serving_engine_prefix_fetch_failures",
                     "serving_prefix_cache_entries",
                     "serving_prefix_cache_bytes"):
            assert name in samples, name
        assert samples["serving_kv_pages_total"]["value"] == 16
        st = eng.stats()
        pg = st["paged"]
        assert pg["enabled"] and pg["total_pages"] == 16
        assert pg["device_prefix"]["inserts"] == 1
        assert st["prefix_fetch_failures"] == 0
        assert st["prefix_cache"]["enabled"]
        dense = ServingEngine(lm, num_slots=2, prefix_cache=False,
                              device="cpu")
        ds = dense.stats()
        assert ds["paged"] == {"enabled": False}
        assert ds["prefix_cache"] == {"enabled": False}
        assert "kv_page_util" not in dense.health()
    finally:
        eng.stop()


def test_step_bucket_stable_across_blame_masks(lms):
    """The step's key follows the OCCUPIED tables, not the active mask: a
    blame probe over a subset reuses the same program."""
    _, lm = lms
    st = _paged(lm)
    rng = np.random.default_rng(4)
    for slot, n in ((0, 5), (1, 21)):
        st.admit(slot, rng.integers(0, 61, n).astype(np.int32), max_new=4)
    st.step(np.array([True, True, False]))
    before = st.paged_stats()["compiled_step_buckets"]
    st.step(np.array([True, False, False]))  # a blame probe's mask
    st.step(np.array([False, True, False]))
    assert st.paged_stats()["compiled_step_buckets"] == before == [8]


def test_no_two_active_rows_share_a_write_target(lms, solo):
    """Over a churned run with shared prefixes, no two active rows of a
    step write the same real (page, offset), no active row writes the
    sentinel or a page it shares, and the streams equal solo decode."""
    _, lm = lms
    st = _paged(lm, num_slots=4)
    rng = np.random.default_rng(17)
    header = rng.integers(0, 61, 9).astype(np.int32)
    prompts = [np.concatenate([header, rng.integers(0, 61, n).astype(
        np.int32)]) if i % 2 else rng.integers(0, 61, n + 3).astype(np.int32)
        for i, n in enumerate((4, 6, 1, 9, 2, 5, 3, 7))]
    steps = [5, 7, 4, 6, 8, 3, 6, 5]
    checked = []

    def check(s, active):
        page, off = s.write_targets(active, s._lens)
        live = [(int(page[i]), int(off[i])) for i in np.flatnonzero(active)]
        assert len(set(live)) == len(live)
        for i, (p, _) in zip(np.flatnonzero(active), live):
            assert p != 0 and p in s._tables[i]
            # held by this slot alone: not shared, not in the index
            assert s._kv_alloc.refcount(p) == 1
        assert (page[~active] == 0).all()
        checked.append(len(live))

    outs = _churn(st, prompts, steps, {1: 1, 2: 2, 3: 3}, on_step=check)
    for p, s, o in zip(prompts, steps, outs):
        assert o == solo(p, s)
    assert max(checked) == 4 and st.prefix_index.stats()["hits"] >= 1


@pytest.mark.parametrize("overlap", [False, True])
def test_quarantined_slot_frees_its_pages(lms, solo, overlap):
    """A poison request blamed by the step fails alone; its slot gives
    its pages back at once, the other streams equal solo decode, and
    after everything the pool holds only the device index's pages."""
    _, lm = lms
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in (4, 7)]
    want = [solo(p, 20) for p in prompts]
    eng = ServingEngine(lm, num_slots=3, paged=True, page_size=4,
                        watchdog_interval=30.0, overlap=overlap,
                        device="cpu").start()
    plan = (
        FaultPlan()
        .arm("stepper.step", times=None,
             when=lambda ctx: bool(ctx["active"][2]))
        .arm("stepper.step", action="delay", delay=0.03, times=None)
    )
    try:
        with plan:
            goods = [eng.submit(p, 20) for p in prompts]
            _wait(lambda: all(len(g.tokens) >= 1 for g in goods),
                  msg="good streams decoding")
            bad = eng.submit(rng.integers(0, 61, 5).astype(np.int32), 10)
            with pytest.raises(InternalError, match="blamed"):
                bad.result(timeout=60)
            assert eng._stepper._tables[2] == []  # freed at quarantine
            for req, w, p in zip(goods, want, prompts):
                assert req.result(timeout=60)[len(p):].tolist() == w
        st = eng.stats()
        assert st["quarantines"] == 1 and st["internal_errors"] == 1
        stp = eng._stepper
        assert all(t == [] for t in stp._tables)
        assert stp._kv_alloc.pages_in_use == stp.prefix_index.reclaimable()
        stp.prefix_index.clear()
        assert stp._kv_alloc.pages_in_use == 0
    finally:
        eng.stop()


def test_supervisor_restart_rebuilds_paged_stepper_keeps_store(lms, solo):
    """A scheduler crash: the supervisor rebuilds a PAGED stepper with a
    fresh pool and an empty device index, the host store survives with
    its entries, and a header request after the restart hits the host
    ladder, token-identical to solo."""
    _, lm = lms
    eng = ServingEngine(
        lm, num_slots=2, paged=True, page_size=4, watchdog_interval=1.0,
        watchdog_grace=30.0, max_restarts=3, restart_backoff=0.01,
        device="cpu",
    ).start()
    rng = np.random.default_rng(6)
    header = rng.integers(0, 61, 17).astype(np.int32)
    try:
        for _ in range(2):  # two touches: the ladder is stored
            eng.generate(header, 3, timeout=60)
        store = eng.prefix_store
        entries = store.stats()["entries"]
        assert entries >= 1 and eng._stepper.prefix_index.stats()[
            "entries"] >= 1
        old = eng._stepper
        plan = (
            FaultPlan()
            .arm("stepper.step", action="delay", delay=0.02, times=None)
            .arm("scheduler.loop", times=1, after=3,
                 when=lambda ctx: ctx["busy"])
        )
        with plan:
            inflight = eng.submit(rng.integers(0, 61, 5).astype(np.int32),
                                  20)
            with pytest.raises(InternalError, match="scheduler crashed"):
                inflight.result(timeout=30)
            _wait(lambda: eng.health()["status"] == "serving"
                  and eng.health()["restarts"] == 1, msg="restart")
        new = eng._stepper
        assert new is not old and new.paged
        assert new.prefix_index.stats()["entries"] == 0
        assert new._kv_alloc.pages_in_use == 0
        assert eng.prefix_store is store
        assert store.stats()["entries"] == entries
        hits = store.stats()["hits"]
        ext = np.concatenate([header, rng.integers(0, 61, 3).astype(
            np.int32)])
        out = eng.generate(ext, 5, timeout=60)
        assert store.stats()["hits"] == hits + 1
        assert out[len(ext):].tolist() == solo(ext, 5)
        assert eng.health()["kv_page_util"] > 0
        warm = [r["key"] for r in eng.compile_ledger.mints()
                if r["trigger"] == "warmup"]
        assert warm == ["paged_step[1]", "paged_step[2]", "paged_step[4]",
                        "paged_step[8]"]
    finally:
        eng.stop()


def test_warm_buckets_then_no_storms(lms, solo):
    """``warmup``, ``warm_prefill_buckets`` and ``warm_restore_buckets`` on
    an idle paged engine cover every program shared-header traffic runs:
    after ``mark_warmed`` it mints no storm, and its streams equal solo."""
    _, lm = lms
    eng = ServingEngine(lm, num_slots=3, paged=True, page_size=4,
                        watchdog_interval=30.0, device="cpu").start()
    try:
        st = eng._stepper
        st.warmup()
        st.warm_prefill_buckets()
        st.warm_restore_buckets()
        keys = {k for k, _ in st._called}
        assert {f"paged_step[{b}]" for b in (1, 2, 4, 8)} <= keys
        assert {f"paged_chunk[{c},8]" for c in (1, 2, 4, 8, 16, 32)} <= keys
        assert {f"paged_restore[{p},8]" for p in (1, 2, 4, 8, 16, 32)} <= keys
        assert st._kv_alloc.pages_in_use == 0  # the warm set used no page
        eng.compile_ledger.mark_warmed()
        rng = np.random.default_rng(12)
        header = rng.integers(0, 61, 17).astype(np.int32)
        reqs = [np.concatenate([header, rng.integers(0, 61, n).astype(
            np.int32)]) for n in (1, 3, 5, 2, 4, 6)]
        for wave in (reqs[:2], reqs[2:]):
            hs = [eng.submit(p, 4) for p in wave]
            for p, h in zip(wave, hs):
                assert h.result(60)[len(p):].tolist() == solo(p, 4)
        assert eng.compile_ledger.snapshot()["storms"] == 0
        assert eng.stats()["paged"]["device_prefix"]["hits"] >= 4
    finally:
        eng.stop()


def test_default_engine_matches_jax_default_on_repeated_prompts(lms, solo):
    """Both packages' engines default to a prefix store; repeated prompts
    (hits from the third touch on) stay token-identical to solo decode,
    with the same store books in both."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    jlm, lm = lms
    rng = np.random.default_rng(31)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in (18, 25)]
    books = {}
    for name, eng in (
        ("jax", JEngine(jlm, num_slots=2, watchdog_interval=30.0)),
        ("torch", ServingEngine(lm, num_slots=2, watchdog_interval=30.0,
                                device="cpu")),
    ):
        eng.start()
        try:
            for _ in range(3):
                for p in prompts:
                    out = eng.generate(p, 4, timeout=60)
                    assert np.asarray(out)[len(p):].tolist() == solo(p, 4)
            s = eng.prefix_store.stats()
            books[name] = {k: s[k] for k in ("hits", "misses", "inserts",
                                             "hit_tokens", "entries",
                                             "bytes")}
        finally:
            eng.stop()
    assert books["torch"] == books["jax"]
    assert books["torch"]["hits"] == 2


# ------------------------------------------------------------- the card


@pytest.mark.gpu
def test_paged_engine_on_card_matches_solo_through_b7():
    """On the card a paged engine with the LayerNorm hook decodes the solo
    generator's tokens, a shared-header request hits the device index, and
    the step runs through B7 (never B4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch import kernels
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = zoo.transformer_lm(**LM)
    assert attach_fused_layernorm(lm) == 5
    solo = CachedSequenceGenerator(lm)
    header = np.arange(3, 20)
    prompts = [np.concatenate([header, [k, k + 1]]) for k in (30, 40)]
    for overlap in (False, True):
        eng = ServingEngine(lm, num_slots=2, paged=True, page_size=4,
                            overlap=overlap).start()
        try:
            kernels.reset_launch_counts()
            outs = [eng.generate(p, 6, timeout=120) for p in prompts]
            counts = kernels.launch_counts()
            hits = eng.stats()["paged"]["device_prefix"]["hits"]
        finally:
            eng.stop()
        for p, o in zip(prompts, outs):
            np.testing.assert_array_equal(o, solo.generate(p[None], 6)[0])
        assert hits == 1
        assert counts["layernorm_fwd"] > 0 and counts["flash_fwd"] == 0


@pytest.mark.gpu
def test_paged_host_phases_never_sync_the_stream():
    """With every paged program warmed, a device-index admission, a
    host-ladder restore, their prefill chunks and the decode dispatches
    run with a step in flight and never synchronize the stream (PyTorch's
    sync debug mode raises on any synchronizing call)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = zoo.transformer_lm(**LM)
    attach_fused_layernorm(lm)
    store = PrefixStore()
    st = DecodeStepper(lm, num_slots=3, paged=True, page_size=4,
                       prefix_cache=store)
    st.warmup()
    st.warm_prefill_buckets()
    st.warm_restore_buckets()
    header = np.arange(1, 19)
    for _ in range(2):  # two touches: the store holds the 16 rung
        st.admit(2, header, max_new=4)
        st.release(2)
        st.prefix_index.clear()
    st.admit(0, header, max_new=4)  # registers 4 pages in the index
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        h = st.step_async(np.array([True, False, False]))
        left = st.begin_admit(1, np.concatenate([header, [7, 8, 9]]),
                              max_new=4)
        assert st.prefix_index.stats()["hits"] == 1
        while left:
            left = st.prefill_chunk(1, 2)
        h2 = st.step_async(np.array([True, True, False]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    h.collect()
    h2.collect()
    st.prefix_index.clear()
    st.release(0)
    st.release(1)
    hits = store.stats()["hits"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        # the host ladder: the index is empty, the store's rung restores
        left = st.begin_admit(1, np.concatenate([header, [5, 6]]),
                              max_new=4)
        assert store.stats()["hits"] == hits + 1
        while left:
            left = st.prefill_chunk(1, 2)
        h3 = st.step_async(np.array([False, True, False]))
    finally:
        torch.cuda.set_sync_debug_mode(0)
    h3.collect()
