"""Grammar-constrained decoding in the port, against the JAX package.

The JAX counterparts: ``tests/test_sampling.py``'s mask-compiler units
(``:138-200``), constrained decoding and the forced-EOS fallback
(``:454-519``), and the engine's masked step/verify programs. Here the
port's ``TokenMaskCompiler`` is held to JAX's mask by mask along seeded
token walks, and the port's engines (dense, paged, n-gram speculative,
``n > 1``, a constrained slot swapped out and back in) to JAX's engines
token for token on the same weights (bridged with ``params_from_jax``),
greedy and sampled; then the books (``serving_constrained_masks``, the
``sampling.mask_exhausted`` event, the masked program keys) and the wire.

The ``gpu``-marked case runs a constrained mix on the card against its
CPU run (``python -m pytest --noconftest tests/test_torch_grammar.py -m
gpu``).
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.obs import FlightRecorder
from distkeras_tpu_torch.serving import (
    DecodeStepper,
    ServingClient,
    ServingEngine,
    ServingError,
    ServingServer,
)
from distkeras_tpu_torch.serving.sampling import (
    SamplingParams,
    TokenMaskCompiler,
)
from distkeras_tpu_torch.utils.convert import params_from_jax
from distkeras_tpu_torch.utils.serialization import serialize_params

torch.set_num_threads(2)

VOCAB = 61
EOS = 60
LM = dict(vocab_size=VOCAB, seq_len=32, d_model=32, num_heads=2, depth=2)

SPECS = {
    "allow": {"kind": "allow", "tokens": [2, 4, 6, 9, 70]},
    "sequence": {"kind": "sequence", "steps": [[3], [4, 5], [6, 7, 8]]},
    "sequence_loop": {"kind": "sequence", "steps": [[3, 11], [4]],
                      "loop": True},
    "choice": {"kind": "choice",
               "sequences": [[7, 8, 9], [7, 8], [7, 12, 13, 14], [20]]},
    "fsm": {"kind": "fsm", "start": "a",
            "states": {"a": {"1": "b", "2": "a"}, "b": {"3": "c"},
                       "c": {"4": "a", "5": "c"}},
            "accept": ["c"]},
}


def _jsp():
    from distkeras_tpu.serving import sampling

    return sampling


@pytest.fixture(scope="module")
def lms():
    import jax

    from distkeras_tpu.models import zoo as jzoo

    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


def _prompt(n, seed=0):
    return np.random.default_rng(seed).integers(0, 50, n).astype(np.int32)


# ------------------------------------------------------- the mask compiler


@pytest.mark.parametrize("eos", [EOS, None], ids=["eos", "no_eos"])
@pytest.mark.parametrize("kind", sorted(SPECS))
def test_masks_equal_jax_along_seeded_walks(kind, eos):
    """At every position of 20 seeded walks (mostly on-grammar tokens, now
    and then an off-grammar one that dead-ends the state) the port's mask
    equals JAX's bit for bit; a clone taken mid-walk then walks on its own
    without moving the original."""
    jsp = _jsp()
    spec = SPECS[kind]
    rng = np.random.default_rng(sorted(SPECS).index(kind) * 100
                                + (eos or 0))
    for _ in range(20):
        mine = TokenMaskCompiler(VOCAB).compile(spec, eos_id=eos)
        ref = jsp.TokenMaskCompiler(VOCAB).compile(spec, eos_id=eos)
        clone_at = int(rng.integers(0, 8))
        for pos in range(12):
            m, r = np.asarray(mine.mask()), np.asarray(ref.mask())
            assert m.dtype == r.dtype and np.array_equal(m, r), (kind, pos)
            allowed = np.flatnonzero(m)
            if allowed.size and rng.random() > 0.1:
                tok = int(rng.choice(allowed))
            else:
                tok = int(rng.integers(0, VOCAB))
            if pos == clone_at:
                twin, jtwin = mine.clone(), ref.clone()
                before = np.asarray(mine.mask()).copy()
                twin.advance(tok)
                jtwin.advance(tok)
                assert np.array_equal(mine.mask(), before)
                assert np.array_equal(twin.mask(), jtwin.mask())
            mine.advance(tok)
            ref.advance(tok)


BAD_SPECS = [
    "nope",
    {"kind": "regex"},
    {"kind": "allow", "tokens": []},
    {"kind": "allow"},
    {"kind": "sequence", "steps": []},
    {"kind": "sequence", "steps": [[]]},
    {"kind": "choice", "sequences": []},
    {"kind": "choice", "sequences": [[1], []]},
    {"kind": "fsm", "start": "x", "states": {}},
    {"kind": "fsm", "start": "x", "states": {"a": {}}},
    {"kind": "fsm", "start": "a", "states": {"a": [1, 2]}},
]


@pytest.mark.parametrize("spec", BAD_SPECS, ids=lambda s: repr(s)[:32])
def test_check_refuses_what_jax_refuses(spec):
    """``TokenMaskCompiler.check`` raises JAX's ``ValueError`` (the same
    message) for each malformed spec, and ``SamplingParams`` refuses it at
    the boundary."""
    jsp = _jsp()
    with pytest.raises(ValueError) as want:
        jsp.TokenMaskCompiler.check(spec)
    with pytest.raises(ValueError) as got:
        TokenMaskCompiler.check(spec)
    assert str(got.value) == str(want.value)
    with pytest.raises(ValueError):
        SamplingParams(grammar=spec)


def test_sampling_params_carry_grammar_like_jax():
    jsp = _jsp()
    for kw in ({"grammar": SPECS["choice"]},
               {"temperature": 0.7, "seed": 5, "grammar": SPECS["fsm"]},
               {"temperature": 0.9, "top_k": 3, "n": 2}):
        mine, ref = SamplingParams(**kw), jsp.SamplingParams(**kw)
        assert mine.to_wire() == ref.to_wire()
        assert (mine.is_greedy, mine.is_default) == (ref.is_greedy,
                                                     ref.is_default)
        assert SamplingParams.from_wire(mine.to_wire()).to_wire() \
            == mine.to_wire()


# --------------------------------------------------------- engines vs JAX


def _mix():
    """Eight requests: four constrained (each kind, greedy and sampled),
    four not, two of them sampled."""
    out = []
    kinds = ["allow", "sequence", "sequence_loop", "choice", "fsm"]
    for i in range(8):
        p = _prompt(int(4 + i % 5), seed=i)
        if i % 2 == 0:
            s = {"grammar": SPECS[kinds[(i // 2) % 5]]}
            if i % 4 == 2:
                s.update(temperature=0.9, seed=30 + i)
        else:
            s = ({"temperature": 0.8, "seed": 40 + i} if i % 4 == 3
                 else None)
        out.append((p, 8, s))
    out.append((_prompt(6, seed=9), 8, {"grammar": SPECS["fsm"],
                                        "temperature": 1.1, "seed": 3}))
    return out


def _jengine(jlm, **kw):
    from distkeras_tpu.serving import ServingEngine as JEngine

    return JEngine(jlm, num_slots=4, prefix_cache=False, **kw).start()


def _pengine(lm, **kw):
    return ServingEngine(lm, num_slots=4, prefix_cache=False, device="cpu",
                         **kw).start()


def _serve(eng, reqs):
    hs = [eng.submit(p, n, eos_id=EOS, sampling=s) for p, n, s in reqs]
    return [eng.wait(h, timeout=120) for h in hs]


def _in_grammar(spec, toks, eos=EOS):
    """A walk of ``spec`` over ``toks`` written apart from
    ``TokenMaskCompiler``: True when every token is one the spec allows
    where it stands, and an eos only where the spec may finish (and
    last)."""
    kind = spec["kind"]
    toks = [int(t) for t in toks]
    state = spec.get("start")
    for j, t in enumerate(toks):
        if kind == "allow":
            ok = t in spec["tokens"] or t == eos
        elif kind == "sequence":
            steps, done = spec["steps"], j >= len(spec["steps"])
            if done and not spec.get("loop"):
                ok = t == eos
            else:
                ok = t in steps[j % len(steps)] or (t == eos and done)
        elif kind == "choice":
            live = [q for q in spec["sequences"] if q[:j] == toks[:j]]
            ok = (any(len(q) > j and q[j] == t for q in live)
                  or (t == eos and any(len(q) == j for q in live)))
        else:  # fsm
            edges = spec["states"].get(state, {})
            if str(t) in edges:
                ok, state = True, edges[str(t)]
            else:
                ok = t == eos and state in spec["accept"]
        if not ok:
            return False
        if t == eos:
            return j == len(toks) - 1
    return True


@pytest.mark.parametrize("mode", ["dense", "paged", "ngram", "paged_ngram"])
def test_constrained_mix_matches_jax_engine(lms, mode):
    """A mixed batch (constrained and not, greedy and sampled, every grammar
    kind) served at once: every reply equals JAX's engine's, token for
    token; every constrained token lies in its grammar; the unconstrained
    replies equal their replies served alone."""
    jlm, lm = lms
    kw = {"paged": "paged" in mode, "page_size": 4}
    if "ngram" in mode:
        kw.update(speculative="ngram", draft_k=3)
    reqs = _mix()
    eng, jeng = _pengine(lm, **kw), _jengine(jlm, **kw)
    try:
        got = _serve(eng, reqs)
        want = _serve(jeng, reqs)
        alone = [eng.generate(p, n, eos_id=EOS, sampling=s, timeout=120)
                 for p, n, s in reqs if s is None or "grammar" not in s]
    finally:
        eng.stop()
        jeng.stop()
    for g, w, (p, _, s) in zip(got, want, reqs):
        assert g.tolist() == w.tolist(), (mode, s)
        if s is not None and "grammar" in s:
            assert _in_grammar(s["grammar"], g[p.size:]), (s, g[p.size:])
    free = [g for g, (_, _, s) in zip(got, reqs)
            if s is None or "grammar" not in s]
    assert [a.tolist() for a in alone] == [f.tolist() for f in free]


def test_n_completions_and_swap_match_jax(lms):
    """A constrained sampled ``n = 3`` request on paged engines (each
    completion walks its cloned grammar) equals JAX's; a constrained slot
    swapped out mid-decode and back in to another slot of the port's
    stepper continues JAX's stepper's stream under the same calls."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    p = _prompt(7, seed=4)
    s = {"grammar": SPECS["allow"], "temperature": 1.0, "seed": 12, "n": 3}
    eng = _pengine(lm, paged=True, page_size=4)
    jeng = _jengine(jlm, paged=True, page_size=4)
    try:
        got = eng.generate(p, 8, eos_id=EOS, sampling=s, timeout=120)
        want = jeng.generate(p, 8, eos_id=EOS, sampling=s, timeout=120)
    finally:
        eng.stop()
        jeng.stop()
    assert [g.tolist() for g in got] == [w.tolist() for w in want]
    assert all(_in_grammar(SPECS["allow"], g[p.size:]) for g in got)
    for paged in (False, True):
        sp = {"grammar": SPECS["choice"]}
        kw = dict(num_slots=2, paged=paged, page_size=4)
        mine = DecodeStepper(lm, device="cpu", **kw)
        ref = JStepper(jlm, **kw)
        outs = []
        for st, params in ((mine, SamplingParams(**sp)),
                           (ref, _jsp().SamplingParams(**sp))):
            st.admit(0, p, sampling=params, max_new=8, eos_id=EOS)
            act0 = np.array([True, False])
            toks = [int(st.step(act0)[0])]
            state = st.swap_out(0)
            assert state["grammar"] is not None
            st.release(0)
            st.swap_in(1, state, max_new=7)
            act1 = np.array([False, True])
            toks += [int(st.step(act1)[1]) for _ in range(3)]
            outs.append(toks)
        assert outs[0] == outs[1] and outs[0][:3] in ([7, 8, 9], [7, 12, 13])


def test_forced_eos_and_mask_books_match_jax(lms):
    """``choice [[7, 8]]`` decodes ``[7, 8, eos]``; a grammar whose only
    token lies outside the vocabulary exhausts at once: forced EOS, a
    ``sampling.mask_exhausted`` event, ``mask_exhaustions``; and
    ``serving_constrained_masks`` counts what JAX's engine counts for the
    same sequential traffic."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    jlm, lm = lms
    p = _prompt(5, seed=13)
    books = {}
    for side, make in (("torch", lambda: _pengine(lm)),
                       ("jax", lambda: _jengine(jlm))):
        eng = make()
        try:
            out = eng.generate(p, 6, eos_id=EOS, sampling={
                "grammar": {"kind": "choice", "sequences": [[7, 8]]}})
            assert out[p.size:].tolist() == [7, 8, EOS]
            for i, s in enumerate(_mix()[:4]):
                eng.generate(s[0], 6, eos_id=EOS, sampling=s[2])
            ms = {m["name"]: m.get("value") for m in eng.metrics_snapshot()}
            books[side] = (ms["serving_constrained_masks"],
                           ms["serving_mask_exhaustions"])
        finally:
            eng.stop()
    assert books["torch"] == books["jax"] and books["torch"][0] > 0
    for side, make in (("torch", lambda r: DecodeStepper(
            lm, num_slots=1, recorder=r, device="cpu")),
            ("jax", lambda r: JStepper(jlm, num_slots=1, recorder=r))):
        rec = (FlightRecorder if side == "torch" else
               __import__("distkeras_tpu.obs", fromlist=["x"])
               .FlightRecorder)(capacity=64)
        st = make(rec)
        sp = (SamplingParams if side == "torch" else _jsp().SamplingParams)(
            grammar={"kind": "choice", "sequences": [[500]]})
        st.admit(0, _prompt(4), sampling=sp, eos_id=EOS)
        assert int(st.step(np.array([True]))[0]) == EOS
        ev = [e for e in rec.snapshot()
              if e["kind"] == "sampling.mask_exhausted"]
        assert len(ev) == 1 and ev[0]["slot"] == 0 and ev[0]["pos"] == 0
        assert st.mask_exhaustions == 1


def test_masked_keys_mint_only_in_warmup(lms):
    """``warmup()`` mints no masked program; ``warm_constrained_buckets()``
    mints JAX's masked keys (every paged step bucket, the verify masked
    and not); after ``mark_warmed`` a constrained mix mints nothing and
    storms 0 times. Without that warm-up the first constrained step mints
    ``step[masked]`` on the serving path."""
    _, lm = lms
    for kw in ({}, {"paged": True, "page_size": 4},
               {"speculative": "ngram", "draft_k": 3}):
        eng = _pengine(lm, **kw)
        try:
            st = eng._stepper
            st.warmup()
            assert not any("masked" in k for k, _ in st._called)
            st.warm_prefill_buckets()
            st.warm_constrained_buckets()
            keys = {k for k, _ in st._called if "masked" in k}
            if kw.get("paged"):
                want = {f"paged_step[{b},masked]" for b in (1, 2, 4, 8)}
            else:
                want = {"step[masked]"}
            if kw.get("speculative"):
                want.add("verify[5,masked]")
            assert keys == want, keys
            eng.compile_ledger.mark_warmed()
            _serve(eng, _mix())
            snap = eng.compile_ledger.snapshot()
            assert snap["storms"] == 0, snap
        finally:
            eng.stop()
    cold = _pengine(lm)
    try:
        cold._stepper.warmup()
        cold.compile_ledger.mark_warmed()
        cold.generate(_prompt(4), 3, sampling={"grammar": SPECS["allow"]})
        assert cold.compile_ledger.snapshot()["storms"] >= 1
        assert ("step[masked]", ()) in cold._stepper._called
    finally:
        cold.stop()


def test_constrained_over_the_wire(lms):
    """Behind a ``ServingServer`` a constrained request equals the same
    request in process, greedy and sampled; a malformed grammar is
    ``bad_request`` and the connection serves on."""
    _, lm = lms
    eng = _pengine(lm)
    srv = ServingServer(eng).start()
    cli = ServingClient(srv.host, srv.port, retry=False, connect_timeout=5)
    try:
        p = _prompt(6, seed=21)
        for s in ({"grammar": SPECS["fsm"]},
                  {"grammar": SPECS["choice"], "temperature": 0.9,
                   "seed": 8}):
            wire = cli.generate(p, 8, eos_id=EOS, sampling=s)
            local = eng.generate(p, 8, eos_id=EOS, sampling=s, timeout=60)
            assert wire.tolist() == local.tolist()
        # the client validates at its own boundary; a raw frame carries
        # the malformed spec to the server
        with pytest.raises(ValueError, match="tokens"):
            cli.generate(p, 4, sampling={"grammar": {"kind": "allow"}})
        sock = cli._sock
        with pytest.raises(ServingError) as ei:
            cli._call({"verb": "generate", "max_new_tokens": 4,
                       "sampling": {"grammar": {"kind": "allow"}}},
                      serialize_params(p))
        assert ei.value.code == "bad_request" and "tokens" in str(ei.value)
        assert cli.generate(p, 2).size == p.size + 2
        assert cli._sock is sock
    finally:
        cli.close()
        srv.shutdown()
        eng.stop()


@pytest.mark.gpu
def test_constrained_mix_on_card_equals_cpu_run():
    """The constrained mix on a CUDA engine (dense and paged, bf16 caches
    too) gives the replies of the same engine on the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cpu = zoo.transformer_lm(**LM, device="cpu")
    gpu = zoo.transformer_lm(**LM, device="cuda")
    gpu.load_state_dict(cpu.state_dict())
    reqs = _mix()
    for kw in ({}, {"paged": True, "page_size": 4},
               {"kv_dtype": torch.bfloat16}):
        outs = []
        for m, dev in ((cpu, "cpu"), (gpu, "cuda")):
            eng = ServingEngine(m, num_slots=4, prefix_cache=False,
                                device=dev, **kw).start()
            try:
                outs.append(_serve(eng, reqs))
            finally:
                eng.stop()
        assert [o.tolist() for o in outs[0]] == [o.tolist() for o in outs[1]]
