"""The port's paged speculative verify against the JAX package.

The bar, from the JAX package's ``tests/test_paged_serving.py``: verify
windows over block-paged pools stay on the solo greedy stream, for
repetitive traffic (proposals fire, variable advance) and random traffic
(rejection-heavy). Beside it: the port's paged speculative stepper holds
JAX's page tables (``pages_for`` reserves the verify's scratch window)
and emits JAX's tokens; one paged verify window writes JAX's context rows
and pool rows (within 1e-5 absolute, the products' f32 summation order);
and over a churned run every window's K/V targets are distinct (page,
offset) pairs of pages the writing slot holds alone — torch's
``index_put_`` picks an arbitrary winner among duplicate indices on CUDA.

All on the CPU, on a small LM (vocab 64, seq 64, d32, 4 heads, depth 2)
with JAX's weights carried into the port; JAX is imported inside the
fixtures and tests, so the ``gpu``-marked case also runs without it.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.predictors import CachedSequenceGenerator
from distkeras_tpu_torch.serving import (
    DecodeStepper,
    ModelDrafter,
    NgramDrafter,
    ServingEngine,
)
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=64, seq_len=64, d_model=32, num_heads=4, depth=2)
VOCAB = LM["vocab_size"]


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


def _paged(lm, drafter, **kw):
    kw.setdefault("num_slots", 2)
    kw.setdefault("page_size", 4)
    kw.setdefault("draft_k", 3)
    return DecodeStepper(lm, paged=True, speculative=drafter, device="cpu",
                         **kw)


def _drive(st, prompts, steps, on_window=None, params=None):
    """Admit ``prompts`` into the slots as they free (``max_new`` = the
    request's steps), run ``spec_step`` windows until every request has
    its tokens. Returns the outputs and one record per window."""
    outs = [[] for _ in prompts]
    queue = list(range(len(prompts)))
    serving, rec = {}, []
    for _ in range(200):
        for slot in range(st.num_slots):
            if slot not in serving and queue:
                ri = queue.pop(0)
                sp = None if params is None else params[ri]
                st.admit(slot, prompts[ri], sampling=sp, max_new=steps[ri])
                serving[slot] = ri
        if not serving:
            break
        active = np.zeros(st.num_slots, bool)
        active[list(serving)] = True
        seqs = [(prompts[serving[i]], outs[serving[i]]) if i in serving
                else None for i in range(st.num_slots)]
        if on_window is not None:
            on_window(st, active)
        toks, counts, used = st.spec_step(active, seqs)
        row = []
        for slot, ri in list(serving.items()):
            em = [int(t) for t in np.atleast_1d(toks[slot])[: counts[slot]]]
            row.append((slot, em))
            outs[ri].extend(em)
            if len(outs[ri]) >= steps[ri]:
                del serving[slot]
                st.release(slot)
        rec.append((row, bool(used), [list(t) for t in st._tables]))
    return [o[:s] for o, s in zip(outs, steps)], rec


def test_paged_speculative_matches_solo(lms, solo):
    _, lm = lms
    st = _paged(lm, NgramDrafter())
    rng = np.random.default_rng(12)
    prompts = [((7 + np.arange(14)) % 13).astype(np.int32),
               rng.integers(0, VOCAB, 9).astype(np.int32)]
    outs, _ = _drive(st, prompts, [8, 8])
    assert outs == [solo(p, 8) for p in prompts]
    assert st.spec_verify_steps > 0


def test_pages_for_reserves_the_verify_window(lms):
    """Speculative: ``pages_for`` adds ``_kb + 1`` positions, capped at
    the padded axis, as JAX's does; the table bucket covers the padded
    axis; a plain stepper's reservation is unchanged."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    st = _paged(lm, NgramDrafter())
    jst = JStepper(jlm, num_slots=2, paged=True, page_size=4,
                   speculative=NgramDrafter(), draft_k=3)
    plain = DecodeStepper(lm, num_slots=2, paged=True, page_size=4,
                          device="cpu")
    for plen, mnew in ((5, 3), (9, 8), (1, 1), (60, 4), (30, 34)):
        assert st.pages_for(plen, mnew) == jst.pages_for(plen, mnew)
        assert st.pages_for(plen, mnew) == -(-min(plen + mnew + 5, 69) // 4)
        assert plain.pages_for(plen, mnew) == -(-min(plen + mnew, 64) // 4)
    assert st._max_pages_bucket == jst._max_pages_bucket == 32
    assert plain._max_pages_bucket == 16
    assert st._kv_alloc.total_pages == jst._kv_alloc.total_pages


@pytest.mark.parametrize("drafter", ["ngram", "self"])
def test_paged_spec_stepper_matches_jax(lms, solo, drafter):
    """The same churned admissions through JAX's paged speculative
    stepper and the port's: equal page tables and equal windows every
    iteration, equal pool books, every stream the solo stream."""
    from distkeras_tpu.serving import ModelDrafter as JModelDrafter
    from distkeras_tpu.serving import NgramDrafter as JNgramDrafter
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    rng = np.random.default_rng(3)
    header = rng.integers(0, VOCAB, 9).astype(np.int32)
    prompts = [np.concatenate([header, header[:5]]),
               rng.integers(0, VOCAB, 6).astype(np.int32),
               np.concatenate([header, rng.integers(0, VOCAB, 4)]).astype(
                   np.int32),
               np.tile(rng.integers(0, VOCAB, 4), 4).astype(np.int32),
               rng.integers(0, VOCAB, 2).astype(np.int32)]
    steps = [9, 7, 8, 10, 6]
    mk = ((NgramDrafter, JNgramDrafter) if drafter == "ngram"
          else (lambda: ModelDrafter(lm), lambda: JModelDrafter(jlm)))
    records = {}
    for name, st in (
        ("torch", _paged(lm, mk[0]())),
        ("jax", JStepper(jlm, num_slots=2, paged=True, page_size=4,
                         speculative=mk[1](), draft_k=3)),
    ):
        outs, rec = _drive(st, prompts, steps)
        records[name] = (outs, rec, st._kv_alloc.stats(),
                         st.prefix_index.stats(), st.spec_verify_steps,
                         st.spec_fallback_steps)
    assert records["torch"] == records["jax"]
    assert [o for o in records["torch"][0]] == [solo(p, s) for p, s in
                                               zip(prompts, steps)]
    assert records["torch"][4] > 0


def test_paged_verify_window_matches_jax(lms):
    """One paged verify window with fixed proposals: equal windows and
    context rows, and the pool rows of every written position within
    1e-5 of JAX's."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    from tests.test_torch_speculative import FixedDrafter

    jlm, lm = lms
    rng = np.random.default_rng(40)
    p0 = rng.integers(0, VOCAB, 9).astype(np.int32)
    p1 = rng.integers(0, VOCAB, 14).astype(np.int32)
    cont = CachedSequenceGenerator(lm, device="cpu").generate(p0[None], 4)[0]
    dtoks = np.array([[cont[9], cont[10], 1, 2], [3, 4, 5, 6]])
    dcnt = np.array([4, 2])
    sts = {"torch": _paged(lm, NgramDrafter(), draft_k=4),
           "jax": JStepper(jlm, num_slots=2, paged=True, page_size=4,
                           speculative=NgramDrafter(), draft_k=4)}
    res = {}
    for name, st in sts.items():
        st.drafter = FixedDrafter(dtoks, dcnt)
        st.admit(0, p0, max_new=6)
        st.admit(1, p1, max_new=6)
        toks, counts, used = st.spec_step(np.array([True, True]))
        res[name] = (np.asarray(toks), np.asarray(counts), used)
    np.testing.assert_array_equal(res["torch"][0], res["jax"][0])
    np.testing.assert_array_equal(res["torch"][1], res["jax"][1])
    assert res["torch"][1][0] >= 3
    pst, jst = sts["torch"], sts["jax"]
    assert pst._tables == jst._tables
    np.testing.assert_array_equal(pst._ctx.numpy(), np.asarray(jst._ctx))
    nh, hd = 4, 8
    for slot, n in ((0, 9 - 1 + 5), (1, 14 - 1 + 5)):
        table = pst._tables[slot]
        for (jk, jv), (pk, pv) in zip(jst._pools, pst._pools):
            for jarr, parr in ((jk, pk), (jv, pv)):
                want = np.asarray(jarr)[table].reshape(-1, nh, hd)[:n]
                got = parr[table].reshape(-1, nh, hd)[:n].numpy()
                np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


def test_no_verify_window_shares_a_write_target(lms, solo):
    """Over a churned run with shared prefixes and every acceptance
    length, each window's K/V targets: an active row's C candidates are
    distinct (page, offset) pairs inside its own table (the overrun past
    its last token lands in the scratch pages ``pages_for`` reserved),
    never the sentinel, never a shared or index-held page, no pair shared
    with another row; inactive rows write the sentinel only. Every stream
    equals solo decode."""
    _, lm = lms
    st = _paged(lm, NgramDrafter(), num_slots=3, draft_k=4)
    rng = np.random.default_rng(17)
    header = rng.integers(0, VOCAB, 9).astype(np.int32)
    prompts = []
    for i, n in enumerate((4, 6, 1, 9, 2, 5, 3, 7)):
        tail = rng.integers(0, VOCAB, n).astype(np.int32)
        prompts.append(np.concatenate([header, tail, header[:6]])
                       if i % 2 else np.tile(tail, 3))
    steps = [8, 10, 6, 9, 12, 5, 7, 11]
    checked = []
    c = st._kb + 1

    def check(s, active):
        page, off = s.write_targets(active, s._lens, c)
        assert page.shape == (s.num_slots, c)
        pairs = []
        for i in np.flatnonzero(active):
            table = s._tables[i]
            pos = np.clip(s._lens[i] - 1, 0, s.max_len - 1) + np.arange(c)
            assert (pos // s.page_size < len(table)).all()
            for p, o in zip(page[i], off[i]):
                assert p != 0 and p in table
                assert s._kv_alloc.refcount(int(p)) == 1
                pairs.append((int(p), int(o)))
        assert len(set(pairs)) == len(pairs)
        assert (page[~active] == 0).all()
        checked.append(int(active.sum()))

    outs, _ = _drive(st, prompts, steps, on_window=check)
    assert outs == [solo(p, s) for p, s in zip(prompts, steps)]
    assert max(checked) == 3 and st.prefix_index.stats()["hits"] >= 1
    assert st.spec_verify_steps > 0 and st.spec_fallback_steps > 0


def test_paged_spec_engine_matches_solo_and_balances_pool(lms, solo):
    """A paged n-gram engine: greedy replies equal solo decode, a sampled
    one the plain engine's, no exhaustion, and after the mix the pages in
    use are exactly the device index's."""
    _, lm = lms
    rng = np.random.default_rng(8)
    span = rng.integers(0, VOCAB, 6)
    prompts = [np.concatenate([np.tile(span, 3), rng.integers(0, VOCAB, 2)])
               .astype(np.int32) for _ in range(5)]
    sps = {"temperature": 0.9, "seed": 4}
    eng = ServingEngine(lm, num_slots=3, paged=True, page_size=4,
                        speculative="ngram", draft_k=3, device="cpu").start()
    plain = ServingEngine(lm, num_slots=3, paged=True, page_size=4,
                          device="cpu").start()
    try:
        hs = [eng.submit(p, 12) for p in prompts]
        outs = [eng.wait(h, timeout=60) for h in hs]
        for p, o in zip(prompts, outs):
            assert o[len(p):].tolist() == solo(p, 12)
        np.testing.assert_array_equal(
            eng.generate(prompts[0], 12, sampling=sps),
            plain.generate(prompts[0], 12, sampling=sps))
        stats = eng.stats()
        st = eng._stepper
        assert stats["paged"]["exhaustions"] == 0
        assert stats["speculative"]["windows"] > 0
        assert st._kv_alloc.pages_in_use == st.prefix_index.reclaimable()
    finally:
        eng.stop()
        plain.stop()


def test_paged_warmup_mints_paged_verify(lms):
    _, lm = lms
    eng = ServingEngine(lm, num_slots=2, paged=True, page_size=4,
                        speculative="ngram", draft_k=3, device="cpu").start()
    try:
        eng._stepper.warmup()
        keys = {m["key"]: m["trigger"] for m in eng.compile_ledger.mints()}
        assert keys["paged_verify[5,32]"] == "warmup"
        assert {f"paged_step[{b}]" for b in (1, 2, 4, 8, 16, 32)} <= set(keys)
        # every write of the warm-up landed on the sentinel page
        assert eng._stepper._kv_alloc.pages_in_use == 0
    finally:
        eng.stop()


def test_paged_sampled_spec_matches_jax_and_replays(lms):
    """Sampled requests on a paged self-draft stepper: JAX's tokens, and
    the plain sampled stream."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    jlm, lm = lms
    rng = np.random.default_rng(9)
    prompts = [rng.integers(0, VOCAB, n).astype(np.int32) for n in (4, 11)]
    params = [dict(temperature=0.8, seed=12),
              dict(temperature=1.2, top_p=0.9, seed=3)]
    st = _paged(lm, ModelDrafter(lm))
    outs, _ = _drive(st, prompts, [9, 9],
                     params=[SamplingParams(**p) for p in params])
    jeng = JEngine(jlm, num_slots=2, prefix_cache=False).start()
    try:
        for p, s, o in zip(prompts, params, outs):
            assert jeng.generate(p, 9, sampling=s)[len(p):].tolist() == o
    finally:
        jeng.stop()
    assert st.spec_verify_steps > 0


@pytest.mark.gpu
def test_paged_spec_engine_on_card_matches_solo():
    """On the card a paged n-gram engine with the LayerNorm hook decodes
    the solo stream through the paged verify."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm

    lm = zoo.transformer_lm(**LM)
    attach_fused_layernorm(lm)
    solo = CachedSequenceGenerator(lm)
    prompts = [np.tile(np.arange(3, 9), 3), np.arange(5, 15) % 4]
    eng = ServingEngine(lm, num_slots=2, paged=True, page_size=4,
                        speculative="ngram", draft_k=3).start()
    try:
        for p in prompts:
            np.testing.assert_array_equal(eng.generate(p, 10, timeout=120),
                                          solo.generate(p[None], 10)[0])
        assert eng.stats()["speculative"]["windows"] > 0
    finally:
        eng.stop()
