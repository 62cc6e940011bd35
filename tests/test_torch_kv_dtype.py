"""bf16 K/V caches (``kv_dtype``) in the port, against the JAX package.

The JAX counterparts: ``tests/test_quantization.py::test_bf16_kv_cache_decode``
(``:145``) and the engine's ``kv_dtype`` paths. Here, on the same weights
(bridged with ``params_from_jax``): the caches and pools after prefill and
decode equal JAX's bit for bit on at least 99.9% of the elements and
within one bf16 ulp on all (the f32 projections may differ in the last
ulp, which can flip one rounding); greedy tokens equal JAX's bf16
generators' on the pinned seeds, for the plain LM and its int8 bundle;
beam search, speculative decode and the engines (dense and paged) decode
JAX's tokens; host rows (prefix-store entries, swap state) hold 2 bytes an
element and round-trip bit for bit; ``kv_bytes_total`` halves; an integer
dtype is refused.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.predictors import (
    BeamSearchGenerator,
    CachedSequenceGenerator,
    SpeculativeGenerator,
)
from distkeras_tpu_torch.serving import DecodeStepper, ServingEngine
from distkeras_tpu_torch.serving.engine import host_rows, rows_tensor
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
BF16 = torch.bfloat16
ULP_SHARE = 0.999  # elements whose bits equal JAX's


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


def _jbf16():
    import jax.numpy as jnp

    return jnp.bfloat16


def _ordered(bits):
    """bf16 bit patterns (uint16) as integers ordered like the values, so
    adjacent representable values differ by 1."""
    b = bits.astype(np.int32)
    return np.where(b & 0x8000, -(b & 0x7FFF), b)


def _jbits(arr):
    return np.asarray(arr).view(np.uint16)


def _assert_ulp_close(mine, theirs, what):
    """``mine`` (port, uint16 bits) against ``theirs`` (JAX, uint16 bits):
    equal on >= 99.9% of the elements, at most 1 ulp apart anywhere."""
    assert mine.shape == theirs.shape, what
    same = float((mine == theirs).mean())
    ulps = int(np.abs(_ordered(mine) - _ordered(theirs)).max())
    assert same >= ULP_SHARE and ulps <= 1, (what, same, ulps)


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 61, n).astype(np.int32)


def _steppers(lms, paged, **kw):
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    extra = {"paged": True, "page_size": 4} if paged else {}
    return (DecodeStepper(lm, kv_dtype=BF16, device="cpu", **extra, **kw),
            JStepper(jlm, kv_dtype=_jbf16(), **extra, **kw))


def _written(mine, theirs, slot):
    """(port bits, JAX bits) of ``slot``'s written positions ``0..len-2``
    per block, read through each stepper's ``swap_out`` (read-only;
    positions past them hold bucket padding neither side attends)."""
    a, b = mine.swap_out(slot)["kv"], theirs.swap_out(slot)["kv"]
    return [(np.stack([k, v]), _jbits(np.stack([jk, jv])))
            for (k, v), (jk, jv) in zip(a, b)]


# --------------------------------------------------- caches against JAX


@pytest.mark.parametrize("admission", ["whole", "chunked", "paged"])
def test_prefill_caches_match_jax_bits(lms, admission):
    """Two slots prefilled (whole prompt, 5-position chunks, or into paged
    pools): every written cache element within one bf16 ulp of JAX's, at
    least 99.9% bit-equal; the banks are half the f32 bytes."""
    mine, theirs = _steppers(lms, admission == "paged", num_slots=2)
    for slot, n in ((0, 17), (1, 26)):
        p = _prompt(n, seed=slot)
        for st in (mine, theirs):
            if admission == "chunked":
                left = st.begin_admit(slot, p)
                while left > 0:
                    left = st.prefill_chunk(slot, 5)
            else:
                st.admit(slot, p, max_new=4)
    rows = [r for slot in (0, 1) for r in _written(mine, theirs, slot)]
    assert all(a.dtype == np.uint16 for a, _ in rows)
    _assert_ulp_close(np.concatenate([a.ravel() for a, _ in rows]),
                      np.concatenate([b.ravel() for _, b in rows]),
                      "prefill")
    assert mine.kv_bytes_total() * 2 == DecodeStepper(
        lms[1], num_slots=2, device="cpu", paged=admission == "paged",
        page_size=4).kv_bytes_total()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_decode_tokens_and_caches_match_jax(lms, paged):
    """Three slots decode 8 steps (one sampled): tokens equal JAX's step
    for step, the written K/V stay within one ulp."""
    from distkeras_tpu.serving.sampling import SamplingParams as JParams

    from distkeras_tpu_torch.serving.sampling import SamplingParams

    mine, theirs = _steppers(lms, paged, num_slots=3)
    for slot in range(3):
        p = _prompt(6 + 5 * slot, seed=10 + slot)
        kw = {"temperature": 0.9, "seed": 4} if slot == 2 else None
        mine.admit(slot, p, max_new=8,
                   sampling=None if kw is None else SamplingParams(**kw))
        theirs.admit(slot, p, max_new=8,
                     sampling=None if kw is None else JParams(**kw))
    active = np.ones(3, bool)
    for _ in range(8):
        assert mine.step(active).tolist() == np.asarray(
            theirs.step(active)).tolist()
    rows = [r for slot in range(3) for r in _written(mine, theirs, slot)]
    _assert_ulp_close(np.concatenate([a.ravel() for a, _ in rows]),
                      np.concatenate([b.ravel() for _, b in rows]),
                      "decode")


# -------------------------------------------------------------- generators


@pytest.mark.parametrize("which", ["plain", "int8_bundle"])
def test_generator_tokens_equal_jax_on_pinned_seeds(which):
    """``test_quantization.py:145``'s model and seeds: bf16-cache greedy
    tokens equal JAX's bf16 generator's (the plain LM, and the int8 bundle
    JAX writes, loaded in the port); the plain LM's bf16/f32 agreement is
    at least 0.9."""
    import jax

    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.ops.quantization import quantize_model as jquant
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached
    from distkeras_tpu.utils import serialization as js

    from distkeras_tpu_torch.utils import serialization as ts

    kw = dict(vocab_size=97, d_model=32, depth=2, seq_len=48, num_heads=4,
              seed=0)
    jlm = jzoo.transformer_lm(**kw)
    if which == "plain":
        lm = zoo.transformer_lm(**kw, device="cpu")
        params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    else:
        jlm = jquant(jlm.copy())
        lm = ts.deserialize_serving_bundle(
            js.serialize_serving_bundle(jlm), device="cpu")
    prompts = np.random.default_rng(5).integers(0, 97, (4, 8))
    got = CachedSequenceGenerator(lm, kv_dtype=BF16,
                                  device="cpu").generate(prompts, 16)
    want = JCached(jlm, kv_dtype=_jbf16()).generate(prompts, 16)
    np.testing.assert_array_equal(got, want)
    if which == "plain":
        f32 = CachedSequenceGenerator(lm, device="cpu").generate(prompts, 16)
        assert (f32[:, 8:] == got[:, 8:]).mean() >= 0.9


def test_ragged_and_sampled_generate_match_jax(lms):
    """Ragged prompts, greedy and sampled, on bf16 caches: JAX's tokens."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    jlm, lm = lms
    prompts = [_prompt(n, seed=n) for n in (3, 9, 14)]
    for kw in ({}, {"temperature": 0.8, "seed": 3, "top_k": 8}):
        got = CachedSequenceGenerator(lm, kv_dtype=BF16, device="cpu",
                                      **kw).generate(prompts, 10)
        want = JCached(jlm, kv_dtype=_jbf16(), **kw).generate(prompts, 10)
        assert [list(g) for g in got] == [list(np.asarray(w)) for w in want]


@pytest.mark.parametrize("which", ["beam", "speculative"])
def test_beam_and_speculative_run_on_bf16_caches(lms, which):
    """``BeamSearchGenerator`` (width 3) and ``SpeculativeGenerator`` (the
    target drafting for itself, k = 3) on bf16 caches decode JAX's tokens;
    their cache banks are bf16."""
    from distkeras_tpu.predictors import (
        BeamSearchGenerator as JBeam,
        SpeculativeGenerator as JSpec,
    )

    jlm, lm = lms
    prompts = np.stack([_prompt(7, seed=s) for s in (1, 2)])
    if which == "beam":
        gen = BeamSearchGenerator(lm, beam_width=3, kv_dtype=BF16,
                                  device="cpu")
        ref = JBeam(jlm, beam_width=3, kv_dtype=_jbf16())
    else:
        gen = SpeculativeGenerator(lm, lm, k=3, kv_dtype=BF16, device="cpu")
        ref = JSpec(jlm, jlm, k=3, kv_dtype=_jbf16())
    np.testing.assert_array_equal(gen.generate(prompts, 12),
                                  np.asarray(ref.generate(prompts, 12)))
    cached = gen._t if which == "speculative" else gen
    assert cached.new_caches(1, 4)[0][0].dtype == BF16


@pytest.mark.parametrize("make", ["generator", "beam", "speculative",
                                  "stepper", "engine"])
def test_integer_kv_dtype_is_refused(lms, make):
    """An integer cache dtype raises ``ValueError`` at construction (JAX
    would truncate K/V into it silently)."""
    _, lm = lms
    build = {
        "generator": lambda dt: CachedSequenceGenerator(lm, kv_dtype=dt,
                                                        device="cpu"),
        "beam": lambda dt: BeamSearchGenerator(lm, kv_dtype=dt,
                                               device="cpu"),
        "speculative": lambda dt: SpeculativeGenerator(lm, lm, kv_dtype=dt,
                                                       device="cpu"),
        "stepper": lambda dt: DecodeStepper(lm, kv_dtype=dt, device="cpu"),
        "engine": lambda dt: ServingEngine(lm, kv_dtype=dt, device="cpu"),
    }[make]
    for dt in (torch.int8, torch.int32, "int8", torch.float64):
        with pytest.raises(ValueError, match="kv_dtype"):
            build(dt)
    assert build("bfloat16") is not None


# ------------------------------------------------------------------ engines


def _mix():
    return [(_prompt(5 + 3 * i, seed=20 + i), 8,
             {"temperature": 0.8, "seed": 7 + i} if i % 3 == 2 else None)
            for i in range(6)]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_engine_replies_match_jax_bf16_engine(lms, paged):
    """A 6-request mix served at once by the port's bf16 engine and JAX's:
    equal replies; the port's ``kv_bytes_total`` is half its f32 twin's."""
    from distkeras_tpu.serving import ServingEngine as JEngine

    jlm, lm = lms
    kw = {"paged": paged, "page_size": 4, "num_slots": 3,
          "prefix_cache": False}
    eng = ServingEngine(lm, kv_dtype=BF16, device="cpu", **kw).start()
    jeng = JEngine(jlm, kv_dtype=_jbf16(), **kw).start()
    f32 = ServingEngine(lm, device="cpu", **kw)
    try:
        outs = []
        for e in (eng, jeng):
            hs = [e.submit(p, n, sampling=s) for p, n, s in _mix()]
            outs.append([e.wait(h, timeout=120).tolist() for h in hs])
        assert outs[0] == outs[1]
        assert eng._stepper.kv_bytes_total() * 2 \
            == f32._stepper.kv_bytes_total()
    finally:
        eng.stop()
        jeng.stop()


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_prefix_entries_half_bytes_and_restore_bit_exact(lms, paged):
    """The same prompt three times on bf16 and f32 engines: the store's
    entries hold uint16 rows, half the f32 entries' bytes; the third
    admission restores them, and the restored slot's K/V equal the
    prefilled ones bit for bit (so the replies equal)."""
    _, lm = lms
    p = _prompt(21, seed=3)
    books = {}
    for dt in (BF16, None):
        eng = ServingEngine(lm, num_slots=2, kv_dtype=dt, paged=paged,
                            page_size=4, device="cpu").start()
        try:
            outs = [eng.generate(p, 5, timeout=60) for _ in range(3)]
            store = eng.prefix_store
            st = eng._stepper
            hit = store.lookup(p[:-1])
            assert hit is not None and hit[0] == 16
            rows = hit[1]
            # restore the hit into slot 1 and fetch it back
            st.begin_admit(1, p, max_new=5)
            back = st._fetch_rows(1, 16)
            st.release(1)
            books[dt] = (store.stats()["bytes"], rows[0][0].dtype,
                         outs, rows, back)
        finally:
            eng.stop()
    (b16, d16, o16, r16, back16), (b32, d32, _, _, _) = books[BF16], books[
        None]
    assert d16 == np.uint16 and d32 == np.float32
    assert b16 * 2 == b32
    assert o16[0].tolist() == o16[1].tolist() == o16[2].tolist()
    for (k, v), (bk, bv) in zip(r16, back16):
        assert np.array_equal(k, bk) and np.array_equal(v, bv)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_swap_state_is_two_bytes_and_round_trips(lms, paged):
    """``swap_out`` of a bf16 slot holds uint16 rows (2 bytes an element,
    within one ulp of JAX's swap state for the same calls); ``swap_in`` to
    another slot and a second ``swap_out`` give the same bits; the resumed
    stream equals the uninterrupted one."""
    mine, theirs = _steppers(lms, paged, num_slots=2)
    p = _prompt(11, seed=8)
    ref = DecodeStepper(lms[1], num_slots=2, kv_dtype=BF16, device="cpu",
                        paged=paged, page_size=4)
    ref.admit(0, p, max_new=10)
    straight = [int(ref.step(np.array([True, False]))[0]) for _ in range(8)]
    for st in (mine, theirs):
        st.admit(0, p, max_new=10)
        for _ in range(4):
            st.step(np.array([True, False]))
    state, jstate = mine.swap_out(0), theirs.swap_out(0)
    elems = 0
    for k, v in state["kv"]:
        assert k.dtype == np.uint16 and k.nbytes == 2 * k.size
        elems += k.size + v.size
    _assert_ulp_close(
        np.concatenate([np.stack([k, v]).ravel() for k, v in state["kv"]]),
        np.concatenate([_jbits(np.stack([k, v])).ravel()
                        for k, v in jstate["kv"]]), "swap")
    mine.release(0)
    mine.swap_in(1, state, max_new=6)
    again = mine.swap_out(1)
    for (k, v), (k2, v2) in zip(state["kv"], again["kv"]):
        assert np.array_equal(k, k2) and np.array_equal(v, v2)
    act = np.array([False, True])
    resumed = [int(mine.step(act)[1]) for _ in range(4)]
    assert resumed == straight[4:]
    assert elems * 2 == sum(k.nbytes + v.nbytes for k, v in state["kv"])


def test_rows_helpers_round_trip_bits():
    """``host_rows``/``rows_tensor``: bf16 as its uint16 bits and back,
    f32/f16 as themselves, and f32 rows rounded into bf16 on request (a
    store shared with an f32 engine)."""
    x = torch.randn(3, 2, 4) * 100
    for dt in (BF16, torch.float16, torch.float32):
        t = x.to(dt)
        h = host_rows(t)
        assert h.nbytes == t.numel() * t.element_size()
        assert torch.equal(rows_tensor(h), t)
    assert torch.equal(rows_tensor(host_rows(x), BF16), x.to(BF16))


def test_from_bundle_takes_kv_dtype(lms, tmp_path):
    """``ServingEngine.from_bundle(path, kv_dtype=...)`` serves an int8
    bundle on bf16 caches with the replies of the same engine built from
    the loaded model."""
    from distkeras_tpu_torch.ops.quantization import quantize_model
    from distkeras_tpu_torch.utils.serialization import (
        load_serving_bundle,
        save_serving_bundle,
    )

    _, lm = lms
    path = str(tmp_path / "lm.dkt")
    save_serving_bundle(path, quantize_model(lm.copy()))
    eng = ServingEngine.from_bundle(path, kv_dtype=BF16, num_slots=2,
                                    device="cpu").start()
    ref = ServingEngine(load_serving_bundle(path, device="cpu"),
                        kv_dtype=BF16, num_slots=2, device="cpu").start()
    try:
        assert eng._stepper.kv_dtype == BF16
        p = _prompt(9, seed=30)
        assert eng.generate(p, 6, timeout=60).tolist() \
            == ref.generate(p, 6, timeout=60).tolist()
    finally:
        eng.stop()
        ref.stop()
