"""The port's tensor-parallel serving (``ServingEngine(mesh="tp:N")``,
``DecodeStepper(mesh=)``) against its solo decode and the JAX package.

The twin of the JAX package's ``tests/test_sharded_serving.py``, on the
CPU: every shard of a ``serving_mesh(..., devices=[cpu] * N)`` lives on
the one CPU device (the port's counterpart of the conftest's 8 virtual
devices, which JAX's meshes here use). Models: JAX's fixtures (``lm``:
d32, 2 heads, depth 2, seed 0; ``lm4h``: 4 heads, seed 1) with their
weights carried into the port by ``params_from_jax``. The bars: a tp:N
slot's greedy and sampled streams equal the port's solo stepper's and
JAX's (solo, and ``DecodeStepper(mesh="tp:N")`` where JAX's sharded
program runs) token for token on every admission path — fresh, chunked,
device-prefix hit, host-ladder restore across geometries, fork,
speculative verify, swap round trip, QoS preemption and the tp:4 engine;
the sharded stage bodies' logits within 1e-5 of JAX's; the decode specs
equal JAX's path for path for the dense, int8 and MoE LMs; the geometry
on every surface. JAX's own speculative-verify test never drafts (its
"repetitive" prompt repeats no 2-token suffix, so ``NgramDrafter``
proposes nothing: 0 verify steps, solo and tp:2); the twin here drafts
with a ``ModelDrafter`` and checks that verify ran.

JAX is imported inside the fixtures and tests, so the ``gpu``-marked
cases run on a machine without it (``python -m pytest --noconftest
tests/test_torch_sharded_serving.py -m gpu``).
"""

from __future__ import annotations

import sys
import time

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.parallel.mesh import DataMesh, serving_mesh
from distkeras_tpu_torch.parallel.tensor_parallel import (
    describe_decode_shardings,
)
from distkeras_tpu_torch.serving import (
    DecodeStepper,
    ModelDrafter,
    PrefixStore,
    ServingEngine,
)
from distkeras_tpu_torch.serving.sampling import SamplingParams
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

CPU = torch.device("cpu")
LM = dict(vocab_size=61, seq_len=32, d_model=32, num_heads=2, depth=2)
LM4H = {**LM, "num_heads": 4}
LOGIT_TOL = 1e-5


def cpu_mesh(n):
    """``tp:n`` with every shard on the CPU."""
    return serving_mesh(f"tp:{n}", devices=[CPU] * n)


def _bridge(jm, tm):
    import jax

    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    return tm


@pytest.fixture(scope="module")
def jlms():
    from distkeras_tpu.models import zoo as jzoo

    return (jzoo.transformer_lm(**LM, seed=0),
            jzoo.transformer_lm(**LM4H, seed=1))


@pytest.fixture(scope="module")
def lm(jlms):
    return _bridge(jlms[0], zoo.transformer_lm(**LM, device="cpu"))


@pytest.fixture(scope="module")
def lm4h(jlms):
    return _bridge(jlms[1], zoo.transformer_lm(**LM4H, device="cpu"))


@pytest.fixture(scope="module")
def solo(jlms):
    """JAX's solo greedy decode: ``solo(prompt, steps)`` -> the tokens."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    ref = JCached(jlms[0])

    def run(p, s):
        out = ref.generate(np.asarray(p, np.int32)[None], steps=s)[0]
        return np.asarray(out)[len(p):].tolist()

    return run


def _decode_slot(st, slot, steps):
    out = []
    for _ in range(steps):
        active = np.zeros(st.num_slots, bool)
        active[slot] = True
        out.append(int(st.step(active)[slot]))
    return out


def _stepper(model, mesh=None, **kw):
    return DecodeStepper(model, device="cpu", prefix_cache=None,
                         mesh=mesh, **kw)


def _specs_equal(port, jax_specs):
    assert port.keys() == jax_specs.keys()
    for k, v in jax_specs.items():
        if isinstance(v, dict):
            assert {f: tuple(s) for f, s in port[k].items()} == {
                f: tuple(s) for f, s in v.items()}, k
        else:
            assert tuple(port[k]) == tuple(v), k


# --------------------------------------------- mesh construction helper


def test_serving_mesh_helper(tp_mesh, cpu_devices):
    """``serving_mesh``'s forms and JAX's loud errors, its shape equal to
    JAX's ``serving_mesh`` over the conftest's devices."""
    pool = [CPU] * 8
    m = serving_mesh("tp:4", devices=pool)
    assert m.shape == {"model": 4} == dict(tp_mesh(4).shape)
    assert m.size == 4 and m.axis_names == ("model",)
    assert m.devices == (CPU,) * 4 and m.home == CPU
    assert serving_mesh(2, devices=pool).shape == {"model": 2}
    assert serving_mesh(m) is m  # passthrough
    with pytest.raises(ValueError, match="needs 16 devices"):
        serving_mesh("tp:16", devices=pool)
    with pytest.raises(ValueError, match="unrecognized"):
        serving_mesh("dp:2", devices=pool)
    with pytest.raises(ValueError, match="unrecognized"):
        serving_mesh("tp:", devices=pool)
    with pytest.raises(ValueError, match=">= 1"):
        serving_mesh(0, devices=pool)
    with pytest.raises(ValueError, match="'model' axis"):
        serving_mesh(DataMesh(2, 0, None, CPU))
    # an explicit device list caps the pool; the CPU pool is one device
    with pytest.raises(ValueError, match="only 2"):
        serving_mesh("tp:4", devices=pool[:2])
    with pytest.raises(ValueError, match="only 1"):
        serving_mesh("tp:2", device="cpu")
    if not torch.cuda.is_available():  # the default pool is the cards
        with pytest.raises(RuntimeError, match="no CUDA device"):
            serving_mesh("tp:1")
    from distkeras_tpu.parallel.mesh import serving_mesh as jserving_mesh

    with pytest.raises(ValueError, match="only 2"):
        jserving_mesh("tp:4", devices=cpu_devices[:2])


def test_decode_param_specs_megatron_pairing(lm, jlms, tp_mesh):
    from distkeras_tpu.parallel.tensor_parallel import (
        describe_decode_shardings as jdescribe,
    )

    d = describe_decode_shardings(lm, cpu_mesh(2))
    _specs_equal(d, jdescribe(jlms[0].params, tp_mesh(2)))
    assert d["1/mhsa/wq"] == (None, "model")  # head- (column-) sharded
    assert d["1/mhsa/wk"] == (None, "model")
    assert d["1/mhsa/wv"] == (None, "model")
    assert d["1/mhsa/wo"] == ("model", None)  # row: one sum per pair
    assert d["1/mhsa/bo"] == ()
    assert d["1/fc1/kernel"] == (None, "model")
    assert d["1/fc1/bias"] == ("model",)
    assert d["1/fc2/kernel"] == ("model", None)
    assert d["1/fc2/bias"] == ()
    assert d["0/tokens"] == ()  # embeddings / LN / head whole
    assert d["3/gamma"] == ()
    assert d["4/kernel"] == ()


@pytest.mark.parametrize("bits", [8, 4])
def test_decode_param_specs_quantized(lm, jlms, tp_mesh, bits):
    """int8 groups shard q like the f32 matrix, their per-column scales
    following a column shard; packed int4 stays whole — JAX's specs."""
    from distkeras_tpu.ops.quantization import quantize_model as jquantize
    from distkeras_tpu.parallel.tensor_parallel import (
        describe_decode_shardings as jdescribe,
    )
    from distkeras_tpu_torch.ops.quantization import quantize_model

    d = describe_decode_shardings(quantize_model(lm.copy(), bits=bits),
                                  cpu_mesh(2))
    _specs_equal(d, jdescribe(jquantize(jlms[0].copy(), bits=bits).params,
                              tp_mesh(2)))
    if bits == 8:
        assert d["1/mhsa/wq/q"] == (None, "model")
        assert d["1/mhsa/wq/s"] == ("model",)
        assert d["1/mhsa/wo/q"] == ("model", None)
        assert d["1/mhsa/wo/s"] == ()
    else:
        assert d["1/mhsa/wq"] == ()


def test_decode_param_specs_moe(tp_mesh):
    """An MoE LM's expert stacks split on their expert axis, the router
    whole; an axis the experts do not divide leaves them whole."""
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.parallel.tensor_parallel import (
        describe_decode_shardings as jdescribe,
    )

    kw = dict(**LM4H, num_experts=4)
    jm = jzoo.moe_transformer_lm(**kw, seed=0)
    m = _bridge(jm, zoo.moe_transformer_lm(**kw, device="cpu"))
    for n in (2, 8):
        d = describe_decode_shardings(m, cpu_mesh(n))
        _specs_equal(d, jdescribe(jm.params, tp_mesh(n)))
    d = describe_decode_shardings(m, cpu_mesh(2))
    assert d["2/wi"] == ("model",) and d["2/router"] == ()
    assert describe_decode_shardings(m, cpu_mesh(8))["2/wi"] == ()


def test_heads_divisibility_is_loud_at_load(lm, jlms):
    from distkeras_tpu.serving import ServingEngine as JEngine
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper

    with pytest.raises(ValueError, match="cannot shard 2 attention"):
        JStepper(jlms[0], num_slots=2, mesh="tp:4")
    with pytest.raises(ValueError, match="cannot shard 2 attention"):
        DecodeStepper(lm, num_slots=2, mesh=cpu_mesh(4), device="cpu")
    # the ENGINE must fail the boot too, never demote to predict-only
    with pytest.raises(ValueError, match="cannot shard 2 attention"):
        ServingEngine(lm, num_slots=2, mesh=cpu_mesh(4), device="cpu")
    with pytest.raises(ValueError, match="needs 16 devices"):
        JEngine(jlms[0], num_slots=2, mesh="tp:16")
    with pytest.raises(ValueError, match="needs 16 devices"):
        ServingEngine(lm, num_slots=2, mesh="tp:16", device="cpu")
    with pytest.raises(ValueError, match="unrecognized"):
        ServingEngine(lm, num_slots=2, mesh="pp:2", device="cpu")
    # the model must live on the mesh's home device
    other = serving_mesh("tp:2", devices=[torch.device("cuda", 0)] * 2)
    with pytest.raises(ValueError, match="home device"):
        DecodeStepper(lm, num_slots=2, mesh=other, device="cpu")


def test_mesh_none_is_bit_for_bit_unchanged(lm):
    """Solo, no placement runs: the stepper reads the model's own leaves.
    A one-shard mesh runs the sharded bodies on copies of them and writes
    solo's K/V bit for bit."""
    st = _stepper(lm, num_slots=2)
    assert st.mesh is None and st.mesh_spec is None
    assert st.mesh_devices == 1
    assert st._params is None and st._gen._shards == {}
    assert st._caches[0][0] is st._kv[0][0][0]
    one = _stepper(lm, cpu_mesh(1), num_slots=2)
    assert one.mesh_spec == "tp:1" and one._caches is None
    w = one._params[0]["1"]["mhsa"]["wq"]
    assert torch.equal(w, lm.layers[1].mhsa.wq)
    assert w.data_ptr() != lm.layers[1].mhsa.wq.data_ptr()  # its own copy
    p = np.arange(3, 14)
    for s in (st, one):
        s.admit(0, p)
    assert _decode_slot(st, 0, 5) == _decode_slot(one, 0, 5)
    for (k, v), (ks, vs) in zip(st._caches, one._kv):
        assert torch.equal(k, ks[0]) and torch.equal(v, vs[0])


def test_sharded_stage_logits_match_jax(lm, jlms):
    """The sharded stage bodies (a whole prefix as one chunk through
    ``_stage_chunk`` on per-shard caches) give JAX's logits within 1e-5,
    at tp:2 on the 2-head LM."""
    x = np.random.default_rng(1).integers(0, 61, (2, 32))
    want = np.asarray(jlms[0](x.astype(np.int32)))
    st = _stepper(lm, cpu_mesh(2), num_slots=2)
    gen = st._gen
    toks = torch.as_tensor(x)
    pos = torch.arange(32)
    h = gen.embed(toks, pos)
    qmask = pos[None, :] <= pos[:, None]
    with torch.no_grad():
        for (blk, moe), (ks, vs) in zip(gen._stages, st._kv):
            h = gen._stage_chunk(blk, moe, h, [k[:2] for k in ks],
                                 [v[:2] for v in vs], 0, qmask)
        got = gen._head(gen._final_ln(h)).numpy()
    np.testing.assert_allclose(got, want, atol=LOGIT_TOL, rtol=0)


# --------------------------------------------- identity: every path


@pytest.fixture(scope="module")
def jax_tp2_streams(jlms):
    """JAX's ``DecodeStepper(mesh="tp:2")`` (paged) on the fresh + chunked
    drive and a sampled stream: the sharded JAX programs' tokens."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper
    from distkeras_tpu.serving.sampling import SamplingParams as JParams

    rng = np.random.default_rng(0)
    prompt = rng.integers(0, 61, 19).astype(np.int32)
    short = rng.integers(0, 61, 5).astype(np.int32)
    st = JStepper(jlms[0], num_slots=2, mesh="tp:2", prefix_cache=None,
                  paged=True, page_size=4)
    st.admit(0, short, max_new=6)
    left = st.begin_admit(1, prompt, max_new=6)
    while left:
        left = st.prefill_chunk(1, 5)
    g = [[], []]
    for _ in range(6):
        t = st.step(np.ones(2, bool))
        g[0].append(int(t[0]))
        g[1].append(int(t[1]))
    sp = np.random.default_rng(3).integers(0, 61, 8).astype(np.int32)
    st2 = JStepper(jlms[0], num_slots=2, mesh="tp:2", prefix_cache=None)
    st2.admit(0, sp, max_new=8,
              sampling=JParams(temperature=0.8, top_k=9, seed=13))
    return {"prompts": (short, prompt), "greedy": g,
            "sampled": _decode_slot(st2, 0, 8)}


def test_sharded_fresh_and_chunked_matches_solo(lm, solo, jax_tp2_streams):
    """Fresh one-shot admission and chunked prefill, dense and paged,
    tp:2: greedy streams equal JAX's solo decode and JAX's tp:2 stepper."""
    short, prompt = jax_tp2_streams["prompts"]
    ref = solo(prompt, 6)
    ref_short = solo(short, 6)
    assert jax_tp2_streams["greedy"] == [ref_short, ref]
    for paged in (False, True):
        st = _stepper(lm, cpu_mesh(2), num_slots=2,
                      **(dict(paged=True, page_size=4) if paged else {}))
        assert st.mesh_spec == "tp:2"
        st.admit(0, short, max_new=6)  # fresh, one-shot
        left = st.begin_admit(1, prompt, max_new=6)  # chunked
        while left:
            left = st.prefill_chunk(1, 5)
        g0, g1 = [], []
        for _ in range(6):
            t = st.step(np.ones(2, bool))
            g0.append(int(t[0]))
            g1.append(int(t[1]))
        assert g0 == ref_short, f"paged={paged}"
        assert g1 == ref, f"paged={paged}"


def test_sharded_sampled_matches_solo_sampled(lm, jax_tp2_streams):
    """The same (prompt, params, seed) on a solo and a tp:2 stepper, dense
    and paged, emits JAX's tp:2 sampled stream."""
    prompt = np.random.default_rng(3).integers(0, 61, 8).astype(np.int32)
    sp = SamplingParams(temperature=0.8, top_k=9, seed=13)
    want = jax_tp2_streams["sampled"]
    for paged in (False, True):
        kw = dict(paged=True, page_size=4) if paged else {}
        for mesh in (None, cpu_mesh(2)):
            st = _stepper(lm, mesh, num_slots=2, **kw)
            st.admit(0, prompt, max_new=8, sampling=sp)
            assert _decode_slot(st, 0, 8) == want, f"paged={paged}"


def test_sharded_device_prefix_hit_matches_solo(lm, solo):
    """Two prompts sharing a long header on a tp:2 paged stepper: the
    second admission shares the header's pages (host refcounts, geometry-
    oblivious) and decodes as solo."""
    st = _stepper(lm, cpu_mesh(2), num_slots=3, paged=True, page_size=4)
    rng = np.random.default_rng(8)
    header = rng.integers(0, 61, 17).astype(np.int32)
    st.admit(0, header, max_new=6)
    assert _decode_slot(st, 0, 6) == solo(header, 6)
    ext = np.concatenate([header, rng.integers(0, 61, 5).astype(np.int32)])
    left = st.begin_admit(1, ext, max_new=6)
    assert st.prefix_index.stats()["hits"] == 1
    assert left == (ext.size - 1) - 16  # 4 full pages skipped
    assert st._kv_alloc.shared_pages >= 4
    while left:
        left = st.prefill_chunk(1, 4)
    assert _decode_slot(st, 1, 6) == solo(ext, 6)


@pytest.mark.parametrize("writer,reader", [(None, 2), (2, None), (4, 2)],
                         ids=["solo_to_tp2", "tp2_to_solo", "tp4_to_tp2"])
def test_host_ladder_restore_crosses_geometries(lm4h, jlms, writer,
                                                reader):
    """The ``PrefixStore`` row format is the full-head layout: an entry
    written by one geometry restores bit-exactly into another, and the
    restored stream is JAX's solo decode."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    store = PrefixStore(max_bytes=8 << 20)
    prompt = np.random.default_rng(9).integers(0, 61, 17).astype(np.int32)
    ref = np.asarray(JCached(jlms[1]).generate(prompt[None], steps=6)[0])
    mesh = {None: None, 2: cpu_mesh(2), 4: cpu_mesh(4)}
    w = DecodeStepper(lm4h, num_slots=1, paged=True, page_size=4,
                      prefix_cache=store, mesh=mesh[writer], device="cpu")
    w.admit(0, prompt, max_new=6)  # miss 1 (ghost rung)
    w.release(0)
    w.prefix_index.clear()
    w.admit(0, prompt, max_new=6)  # miss 2: ladder stored
    rows = w._fetch_rows(0, prompt.size - 1)
    w.release(0)
    assert store.stats()["entries"] >= 1
    st = DecodeStepper(lm4h, num_slots=2, paged=True, page_size=4,
                       prefix_cache=store, mesh=mesh[reader], device="cpu")
    st.prefix_index.clear()  # force the HOST ladder path
    left = st.begin_admit(1, prompt, max_new=6)
    assert store.stats()["hits"] >= 1
    assert left < prompt.size - 1  # the rung skipped real prefill
    hit = store.lookup(prompt[:-1])[0]
    for (k, v), (rk, rv) in zip(st._fetch_rows(1, hit), rows):
        np.testing.assert_array_equal(k, rk[:hit])
        np.testing.assert_array_equal(v, rv[:hit])
    while left:
        left = st.prefill_chunk(1, 4)
    assert _decode_slot(st, 1, 6) == ref[len(prompt):].tolist()


def test_sharded_fork_n_parallel_sampled(lm, jlms):
    """Copy-on-write forks on a tp:2 paged stepper: each completion's
    sampled stream equals an independent solo admission (port and JAX)
    under the derived completion seed, and the fork shared pages."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper
    from distkeras_tpu.serving.sampling import SamplingParams as JParams
    from distkeras_tpu_torch.serving.sampling import seed_for_completion

    prompt = np.random.default_rng(10).integers(0, 61, 9).astype(np.int32)
    want = []
    for c in range(3):
        seed = seed_for_completion(31, c)
        js = JStepper(jlms[0], num_slots=1, prefix_cache=None)
        js.admit(0, prompt, max_new=8,
                 sampling=JParams(temperature=0.9, seed=seed))
        want.append(_decode_slot(js, 0, 8))
        ps = _stepper(lm, num_slots=1)
        ps.admit(0, prompt, max_new=8,
                 sampling=SamplingParams(temperature=0.9, seed=seed))
        assert _decode_slot(ps, 0, 8) == want[-1]
    st = _stepper(lm, cpu_mesh(2), num_slots=3, paged=True, page_size=4)
    st.admit(0, prompt, max_new=9,
             sampling=SamplingParams(temperature=0.9, seed=31))
    st.fork_slot(0, 1, max_new=8, completion=1)
    st.fork_slot(0, 2, max_new=8, completion=2)
    assert st._kv_alloc.shared_pages >= 2
    got = [[], [], []]
    for _ in range(8):
        t = st.step(np.ones(3, bool))
        for i in range(3):
            got[i].append(int(t[i]))
    assert got == want


def _spec_drive(st, prompts, params, steps):
    for slot, p in enumerate(prompts):
        st.admit(slot, p, max_new=steps, sampling=params[slot])
    outs = [[] for _ in prompts]
    live = set(range(len(prompts)))
    while live:
        active = np.zeros(st.num_slots, bool)
        active[list(live)] = True
        seqs = [(prompts[i], outs[i]) if i in live else None
                for i in range(st.num_slots)]
        toks, counts, _ = st.spec_step(active, seqs)
        for i in list(live):
            for t in np.atleast_1d(toks[i])[: int(counts[i])]:
                outs[i].append(int(t))
                if len(outs[i]) == steps:
                    live.discard(i)
                    st.release(i)
                    break
    return outs


def test_sharded_speculative_verify_matches_solo(lm, lm4h, jlms, solo):
    """The paged verify program over a tp:2 mesh, with a draft that
    proposes (a ``ModelDrafter`` on the 4-head LM): the solo spec stepper
    runs verify windows (checked first), greedy and sampled; the tp:2 spec
    stepper emits its streams, and both equal JAX's solo spec stepper with
    the same drafter (greedy: JAX's solo decode)."""
    from distkeras_tpu.serving import ModelDrafter as JModelDrafter
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper
    from distkeras_tpu.serving.sampling import SamplingParams as JParams

    rng = np.random.default_rng(12)
    prompts = [((7 + np.arange(14)) % 13).astype(np.int32),
               rng.integers(0, 61, 9).astype(np.int32)]
    kw = dict(num_slots=2, paged=True, page_size=4, draft_k=3)
    ps = _stepper(lm, speculative=ModelDrafter(lm4h), **kw)
    want = _spec_drive(ps, prompts,
                       [None, SamplingParams(temperature=0.8, seed=5)], 8)
    assert ps.spec_verify_steps > 0  # the drafts fire solo
    assert want[0] == solo(prompts[0], 8)  # greedy pin
    js = JStepper(jlms[0], speculative=JModelDrafter(jlms[1]),
                  prefix_cache=None, **kw)
    assert _spec_drive(js, prompts,
                       [None, JParams(temperature=0.8, seed=5)], 8) == want
    st = _stepper(lm, cpu_mesh(2), speculative=ModelDrafter(lm4h), **kw)
    got = _spec_drive(st, prompts,
                      [None, SamplingParams(temperature=0.8, seed=5)], 8)
    assert got == want
    assert st.spec_verify_steps > 0  # the sharded verify actually ran
    assert st.drafter._st.mesh is None  # the draft bank stays solo


def test_sharded_swap_roundtrip_matches_solo(lm, jlms, solo):
    """The QoS preemption seam on a tp:2 paged stepper: decode, swap out
    (the host rows join the shards' heads), release, swap in to another
    slot: the stream continues as an uninterrupted solo decode, greedy and
    sampled (JAX's solo sampled stepper)."""
    from distkeras_tpu.serving.engine import DecodeStepper as JStepper
    from distkeras_tpu.serving.sampling import SamplingParams as JParams

    prompt = np.random.default_rng(14).integers(0, 61, 9).astype(np.int32)
    js = JStepper(jlms[0], num_slots=1, prefix_cache=None)
    js.admit(0, prompt, max_new=8, sampling=JParams(temperature=0.8,
                                                     seed=23))
    cases = [(None, solo(prompt, 8)),
             (SamplingParams(temperature=0.8, seed=23),
              _decode_slot(js, 0, 8))]
    for sampling, want in cases:
        st = _stepper(lm, cpu_mesh(2), num_slots=2, paged=True, page_size=4)
        st.admit(0, prompt, max_new=8, sampling=sampling)
        head = _decode_slot(st, 0, 3)
        state = st.swap_out(0)
        assert state["kv"][0][0].shape == (prompt.size + 2, 2, 16)
        st.release(0)
        st.swap_in(1, state, max_new=5)
        tail = _decode_slot(st, 1, 5)
        assert head + tail == want, f"sampling={sampling}"


def test_engine_qos_preemption_under_mesh(lm, solo):
    """Preempt-by-swap on a tp:2 engine: a tight pool and a high-priority
    arrival preempt the low-priority stream; both complete as solo."""
    from distkeras_tpu_torch.serving import QosPolicy

    rng = np.random.default_rng(15)
    lo_p = rng.integers(0, 61, 9).astype(np.int32)
    hi_p = rng.integers(0, 61, 7).astype(np.int32)
    eng = ServingEngine(
        lm, num_slots=2, mesh=cpu_mesh(2), paged=True, page_size=4,
        num_pages=8, prefix_cache=False, queue_capacity=8,
        qos=QosPolicy(preempt=True, max_preemptions=2),
        watchdog_interval=30.0, device="cpu",
    ).start()
    try:
        lo = eng.submit(lo_p, 8, tenant="lo", priority=0)
        for _ in range(200):  # lo decodes before the preemptor arrives
            if eng.batcher.stats()["active_slots"]:
                break
            time.sleep(0.01)
        hi = eng.submit(hi_p, 4, tenant="hi", priority=2)
        assert eng.wait(lo, 120)[len(lo_p):].tolist() == solo(lo_p, 8)
        assert eng.wait(hi, 120)[len(hi_p):].tolist() == solo(hi_p, 4)
        assert eng.stats()["preemptions"] >= 0  # tight-pool path exercised
    finally:
        eng.stop()


# --------------------------------------------- tp:4 + observability


def test_tp4_engine_every_admission_path(lm4h, jlms):
    """``ServingEngine(mesh="tp:4")`` on the 4-head LM serves greedy,
    sampled and an n=2 fork group as the solo engine does (greedy: JAX's
    solo decode), and the geometry rides health, stats and the gauges."""
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached

    rng = np.random.default_rng(16)
    reqs = [
        (rng.integers(0, 61, 7).astype(np.int32), 6, None),
        (rng.integers(0, 61, 11).astype(np.int32), 5,
         SamplingParams(temperature=0.8, seed=41)),
        (rng.integers(0, 61, 6).astype(np.int32), 5,
         SamplingParams(temperature=0.9, seed=42, n=2)),
    ]

    def run(mesh):
        eng = ServingEngine(
            lm4h, num_slots=4, mesh=mesh, paged=True, page_size=4,
            prefix_cache=False, watchdog_interval=30.0, device="cpu",
        ).start()
        try:
            outs = [eng.generate(p, s, sampling=sp) for p, s, sp in reqs]
            return outs, eng.health(), eng.stats(), {
                s["name"]: s["value"] for s in eng.metrics_snapshot()
                if s["kind"] == "gauge"}
        finally:
            eng.stop()

    want, h0, st0, g0 = run(None)
    got, h4, st4, gauges = run(cpu_mesh(4))
    p, s, _ = reqs[0]
    np.testing.assert_array_equal(
        want[0], np.asarray(JCached(jlms[1]).generate(p[None], steps=s)[0]))
    for w, g in zip(want, got):
        if isinstance(w, list):
            assert len(w) == len(g) == 2
            for a, b in zip(w, g):
                np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_array_equal(w, g)
    assert h0["mesh"] is None and h4["mesh"] == "tp:4"
    assert h4["kv_shard_bytes"] * 4 == st4["paged"]["kv_bytes_total"]
    assert st4["paged"]["mesh"] == "tp:4" and st0["paged"]["mesh"] is None
    assert st4["mesh"] == "tp:4" and st0["mesh"] is None
    # equal total K/V bytes across geometries at the same config
    assert st4["paged"]["kv_bytes_total"] == st0["paged"]["kv_bytes_total"]
    assert gauges["serving_mesh_devices"] == 4
    assert gauges["serving_kv_shard_bytes"] == h4["kv_shard_bytes"]
    assert g0["serving_mesh_devices"] == 1
    assert g0["serving_kv_shard_bytes"] == h0["kv_shard_bytes"] \
        == st0["paged"]["kv_bytes_total"]


def test_moe_engine_tp2_matches_jax():
    """The MoE LM at tp:2 (2 experts a shard, the no-drop branch summed
    over the shards): the engine's greedy replies, dense and paged, equal
    JAX's solo cached decode; the sharded branch equals ``moe_nodrop``
    within 1e-6."""
    from distkeras_tpu.models import zoo as jzoo
    from distkeras_tpu.predictors import CachedSequenceGenerator as JCached
    from distkeras_tpu_torch.parallel.expert_parallel import (
        moe_nodrop,
        moe_nodrop_shards,
    )

    kw = dict(**LM4H, num_experts=4)
    jm = jzoo.moe_transformer_lm(**kw, seed=0)
    m = _bridge(jm, zoo.moe_transformer_lm(**kw, device="cpu"))
    layer = m.layers[2]
    x = torch.as_tensor(np.random.default_rng(2).normal(size=(3, 5, 32)),
                        dtype=torch.float32)
    experts = [(layer.wi[i:i + 2], layer.wo[i:i + 2], i) for i in (0, 2)]
    np.testing.assert_allclose(
        moe_nodrop_shards(layer.router, experts, x).detach().numpy(),
        moe_nodrop(layer.expert_params(), x).detach().numpy(),
        atol=1e-6, rtol=0)
    prompts = [np.random.default_rng(s).integers(0, 61, n).astype(np.int32)
               for s, n in ((1, 5), (2, 13))]
    ref = JCached(jm)
    want = [np.asarray(ref.generate(p[None], steps=6)[0]) for p in prompts]
    for paged in (False, True):
        eng = ServingEngine(m, num_slots=2, mesh=cpu_mesh(2), paged=paged,
                            page_size=4, prefix_cache=False,
                            watchdog_interval=30.0, device="cpu").start()
        try:
            got = [eng.generate(p, 6) for p in prompts]
        finally:
            eng.stop()
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("bits", [8, 4])
def test_quantized_tp2_matches_solo(lm4h, bits):
    """A quantized bundle's model at tp:2: int8 pairs split per field
    (the scales of a row shard whole on each shard), packed int4 weights
    run whole on home with each shard's heads cut out — both decode as
    the solo stepper does, and the model's own weights stay unsplit."""
    from distkeras_tpu_torch.ops.quantization import quantize_model

    q = quantize_model(lm4h.copy(), bits=bits)
    prompts = [np.random.default_rng(s).integers(0, 61, 6 + s)
               for s in range(2)]
    streams = []
    for mesh in (None, cpu_mesh(2)):
        st = _stepper(q, mesh, num_slots=2, paged=True, page_size=4)
        for i, p in enumerate(prompts):
            st.admit(i, p)
        streams.append([st.step(np.ones(2, bool)).tolist()
                        for _ in range(6)])
    assert streams[0] == streams[1]
    whole = q.layers[1].mhsa.wq
    assert (whole["q"] if bits == 8 else whole.q4).shape[1] == 32


def test_scheduler_books_carry_mesh(lm):
    """The scheduler's ``load()`` and ``stats()`` carry the stepper's
    geometry (None solo): the field health and the fleet read."""
    from distkeras_tpu_torch.serving.scheduler import ContinuousBatcher

    for mesh, want in ((None, None), (cpu_mesh(2), "tp:2")):
        b = ContinuousBatcher(_stepper(lm, mesh, num_slots=2))
        assert b.load()["mesh"] == want and b.stats()["mesh"] == want


def test_supervisor_restart_keeps_the_mesh(lm, solo):
    """A crashed scheduler's restart rebuilds the stepper on the same
    mesh; the next reply is still solo's."""
    from distkeras_tpu_torch.faults import FaultPlan

    prompt = np.arange(1, 6, dtype=np.int32)
    eng = ServingEngine(lm, num_slots=2, mesh=cpu_mesh(2), device="cpu",
                        watchdog_interval=1.0, watchdog_grace=30.0,
                        max_restarts=3, restart_backoff=0.01).start()
    first = eng._stepper
    try:
        with FaultPlan().arm("scheduler.loop", times=1):
            deadline = time.monotonic() + 30
            while eng.health()["restarts"] < 1:
                assert time.monotonic() < deadline, "no restart"
                time.sleep(0.02)
        while eng.health()["status"] != "serving":
            assert time.monotonic() < deadline, "not serving again"
            time.sleep(0.02)
        assert eng._stepper is not first
        assert eng._stepper.mesh is first.mesh
        assert eng.health()["mesh"] == "tp:2"
        assert eng.generate(prompt, 6, timeout=60)[5:].tolist() == \
            solo(prompt, 6)
    finally:
        eng.stop()


def test_fleet_replica_books_carry_mesh():
    from distkeras_tpu_torch.serving.fleet import _Replica

    r = _Replica(("127.0.0.1", 9001))
    assert r.snapshot()["mesh"] is None  # no health seen yet
    r.last_health = {"status": "serving", "mesh": "tp:2",
                     "num_slots": 4, "queue_capacity": 8}
    assert r.snapshot()["mesh"] == "tp:2"


def test_dkt_top_renders_mesh_column(lm4h):
    """``tools/dkt_top.py`` renders the port engines' mesh gauge per
    replica."""
    sys.path.insert(0, "tools")
    from dkt_top import format_table

    samples = []
    for port, mesh in ((9001, cpu_mesh(4)), (9002, None)):
        eng = ServingEngine(lm4h, num_slots=2, mesh=mesh, device="cpu",
                            history=False)
        samples += [dict(s, labels={**s.get("labels", {}),
                                    "replica": f"127.0.0.1:{port}"})
                    for s in eng.metrics_snapshot()
                    if s["name"] == "serving_mesh_devices"]
    out = format_table(samples)
    assert "== 127.0.0.1:9001  mesh=tp:4 " in out
    assert "== 127.0.0.1:9002  mesh=solo " in out


# --------------------------------------------- on the card


def _card_lm():
    from distkeras_tpu_torch.ops.fused_layernorm import (
        attach_fused_layernorm,
    )

    lm = zoo.transformer_lm(vocab_size=512, seq_len=64, d_model=64,
                            num_heads=4, depth=8, seed=0)
    assert attach_fused_layernorm(lm) == 17
    prompts = [np.random.default_rng(s).integers(0, 512, 9 + s)
               for s in range(3)]
    mesh = serving_mesh("tp:2", devices=[torch.device("cuda", 0)] * 2)
    return lm, prompts, mesh


@pytest.mark.gpu
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_tp2_decode_on_the_card_matches_solo(paged):
    """On the card, both shards on ``cuda:0``: a tp:2 stepper's greedy
    stream equals the solo stepper's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    lm, prompts, mesh = _card_lm()
    kw = dict(paged=True, page_size=8) if paged else {}
    streams = []
    for m in (None, mesh):
        st = DecodeStepper(lm, num_slots=3, mesh=m, **kw)
        for i, p in enumerate(prompts):
            st.admit(i, p)
        streams.append([st.step(np.ones(3, bool)).tolist()
                        for _ in range(8)])
    assert streams[0] == streams[1]


@pytest.mark.gpu
def test_tp2_b7_launches_on_the_card_equal_solo():
    """B7 launches 17 times a decode step at tp:2, as solo: the
    LayerNorms run once, on the home device, not once a shard."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    from distkeras_tpu_torch import kernels

    lm, prompts, mesh = _card_lm()
    per_step = []
    for m in (None, mesh):
        st = DecodeStepper(lm, num_slots=3, mesh=m)
        for i, p in enumerate(prompts):
            st.admit(i, p)
        st.step(np.ones(3, bool))
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        st.step(np.ones(3, bool))
        torch.cuda.synchronize()
        per_step.append(kernels.launch_counts()["layernorm_fwd"])
    assert per_step == [17, 17]
