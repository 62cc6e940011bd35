"""The PyTorch port's commit/pull compression (``distkeras_tpu_torch.utils.
compression``) and the in-process async tier that uses it, vs the JAX
package on the CPU.

The codecs are host numpy in both packages, so on the same trees they
give the same payloads bit for bit. Through the trainers (simulated mode,
the same seeded schedule, bridged weights) each commit is compared
payload by payload; there the deltas themselves differ in the last bits
(the matmul summation order), which can move an int8 code by one step
where a value sits at a rounding boundary — each test states its
tolerance.
"""

import functools

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import AEASGD as JAEASGD
from distkeras_tpu import DOWNPOUR as JDOWNPOUR
from distkeras_tpu import parameter_servers as jps
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.utils import compression as jc
from distkeras_tpu_torch import AEASGD, DOWNPOUR, zoo
from distkeras_tpu_torch import parameter_servers as tps
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.utils import compression as tc
from distkeras_tpu_torch.utils.checkpoint import Checkpointer
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

ASYNC = dict(loss="categorical_crossentropy", learning_rate=0.02,
             batch_size=32, num_epoch=2, num_workers=4,
             communication_window=4, label_col="label_onehot",
             mode="simulated", seed=0)


@pytest.fixture(autouse=True)
def _uncached_jax_cores(monkeypatch):
    """Uncached JAX cores (``DKT_DISABLE_CORE_CACHE``), so no later JAX
    test in this process is handed one of these runs' cores."""
    monkeypatch.setenv("DKT_DISABLE_CORE_CACHE", "1")


def _tree(seed=0, special=False):
    """A parameter dict in the port's layout (names sorted, as the JAX
    leaf order sorts a flat dict's keys)."""
    rng = np.random.default_rng(seed)
    tree = {
        "0.bias": rng.standard_normal(33).astype(np.float32) * 1e-3,
        "0.kernel": rng.standard_normal((64, 33)).astype(np.float32),
        "1.kernel": rng.standard_normal((33, 10)).astype(np.float32) * 50,
        "2.zero": np.zeros((4, 4), np.float32),
    }
    if special:
        tree["3.nan"] = np.array([1.0, np.nan, -2.0, np.inf], np.float32)
        tree["4.steps"] = np.arange(3, dtype=np.int64)
        tree["5.tiny"] = np.array([1e-40, -3e-39, 2.5], np.float32)
    return tree


def _flat(payload):
    """A payload's arrays in leaf order (nested dicts flattened with their
    keys sorted, as JAX flattens them)."""
    return jax.tree.leaves(jax.tree.map(np.asarray, payload))


def _assert_same_payload(port, ref):
    a, b = _flat(port), _flat(ref)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_commit_codec_bit_equal_jax(seed):
    """``quantize_tree``/``dequantize_tree``: the same int8 codes and f32
    scales, the same reconstruction (a zero leaf quantizes to zeros with
    scale 0), ``maybe_decompress`` passes raw deltas through."""
    tree = _tree(seed)
    (pa, da), (pb, db) = tc.quantize_tree(tree), jc.quantize_tree(tree)
    assert tc.is_compressed(pa) and list(pa[tc.Q8_KEY]["q"]) == list(tree)
    _assert_same_payload(pa, pb)
    _assert_same_payload(da, db)
    _assert_same_payload(tc.dequantize_tree(pa), jc.dequantize_tree(pb))
    _assert_same_payload(tc.maybe_decompress(pa), da)
    assert tc.maybe_decompress(tree) is tree
    assert pa[tc.Q8_KEY]["s"]["2.zero"] == 0
    for k in tree:  # error <= half a step per element
        step = pa[tc.Q8_KEY]["s"][k]
        assert np.abs(da[k] - tree[k]).max() <= step / 2 * (1 + 1e-6)


def test_nonfinite_deltas_fail_loudly_like_jax():
    """A diverged (non-finite) delta is refused by both commit codecs with
    JAX's FloatingPointError, before any residual is touched."""
    bad = _tree(special=True)
    del bad["4.steps"]
    for mod in (tc, jc):
        with pytest.raises(FloatingPointError, match="refusing to quantize"):
            mod.quantize_tree(bad)
        with pytest.raises(FloatingPointError, match="refusing to sparsify"):
            mod.topk_compress(bad, 0.1)


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_error_feedback_residual_bit_equal_jax(kind):
    """Five commits through ``compress_with_feedback`` /
    ``topk_compress_with_feedback``: each payload and each residual equal
    JAX's bit for bit, and the mass is conserved — the shipped sum plus
    the last residual is the raw deltas' sum, to the f32 rounding of the
    five additions (8 ulps of the leaf's largest magnitude)."""
    port, ref = ((tc.compress_with_feedback, jc.compress_with_feedback)
                 if kind == "int8" else
                 (functools.partial(tc.topk_compress_with_feedback, frac=0.1),
                  functools.partial(jc.topk_compress_with_feedback,
                                    frac=0.1)))
    ra = rb = None
    shipped = raw = None
    for step in range(5):
        delta = _tree(10 + step)
        pa, ra = port(delta, ra)
        pb, rb = ref(delta, rb)
        _assert_same_payload(pa, pb)
        _assert_same_payload(ra, rb)
        got = tc.maybe_decompress(pa)
        shipped = got if shipped is None else {
            k: shipped[k] + got[k] for k in got}
        raw = delta if raw is None else {k: raw[k] + delta[k] for k in delta}
    for k in raw:
        ulp = np.spacing(np.abs(raw[k]).max())
        np.testing.assert_allclose(shipped[k] + ra[k], raw[k], rtol=0,
                                   atol=8 * ulp)


@pytest.mark.parametrize("frac", [0.01, 0.05, 0.5, 1.0])
def test_topk_codec_bit_equal_jax(frac):
    """``topk_compress``: the same (int32 index, f32 value) pairs, shapes
    and dense reconstruction; k = ceil(frac * n) per leaf, at least 1."""
    tree = _tree(3)
    (pa, da), (pb, db) = tc.topk_compress(tree, frac), jc.topk_compress(
        tree, frac)
    assert tc.is_topk(pa)
    _assert_same_payload(pa, pb)
    _assert_same_payload(da, db)
    _assert_same_payload(tc.topk_decompress(pa), jc.topk_decompress(pb))
    for k, v in tree.items():
        assert len(pa[tc.TOPK_KEY]["i"][k]) == max(1, int(np.ceil(frac
                                                                  * v.size)))


def test_pull_codecs_bit_equal_jax():
    """The bf16 and int8 pull codecs: the same payloads; NaN and inf leaves
    stay NaN and inf (bf16: truncated, a NaN kept NaN; int8: carried raw,
    flagged), integer leaves pass through, subnormals round as JAX's."""
    tree = _tree(4, special=True)
    for enc, jenc, dec, jdec in (
            (tc.bf16_encode_tree, jc.bf16_encode_tree, tc.bf16_decode_tree,
             jc.bf16_decode_tree),
            (tc.int8_encode_tree, jc.int8_encode_tree, tc.int8_decode_tree,
             jc.int8_decode_tree)):
        pa, pb = enc(tree), jenc(tree)
        _assert_same_payload(pa, pb)
        out = dec(pa)
        _assert_same_payload(out, jdec(pb))
        _assert_same_payload(tc.maybe_decode_pull(pa), out)
        assert np.isnan(out["3.nan"][1]) and np.isinf(out["3.nan"][3])
        np.testing.assert_array_equal(out["4.steps"], tree["4.steps"])
    assert tc.maybe_decode_pull(tree) is tree


def test_spec_parsing_matches_jax():
    """``parse_compress_spec`` and ``validate_pull_compress`` accept and
    refuse the same values, with the same messages."""
    for spec in (None, "int8", "topk", "topk:0.05", "topk:1"):
        assert tc.parse_compress_spec(spec) == jc.parse_compress_spec(spec)
    for bad in ("int4", "topk:0", "topk:1.5", 8):
        with pytest.raises(ValueError) as a:
            tc.parse_compress_spec(bad)
        with pytest.raises(ValueError) as b:
            jc.parse_compress_spec(bad)
        assert str(a.value) == str(b.value)
    assert tc.PULL_COMPRESS_VALUES == jc.PULL_COMPRESS_VALUES
    with pytest.raises(ValueError, match="pull_compress must be one of"):
        tc.validate_pull_compress("fp8")
    _, tm = _mlps()
    with pytest.raises(ValueError, match="compress must be None"):
        DOWNPOUR(tm, "sgd", device="cpu", compress="int4")
    with pytest.raises(ValueError, match="pull_compress must be one of"):
        DOWNPOUR(tm, "sgd", device="cpu", pull_compress="fp8")


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_ps_pull_and_commit_codecs_match_jax(mode):
    """The parameter server's ``pull_compress`` encodes the pulled center
    as JAX's does; a compressed commit is reconstructed before the rule,
    so the center moves as JAX's by the dequantized delta."""
    center = _tree(5)
    port = tps.DeltaParameterServer(center, pull_compress=mode)
    ref = jps.DeltaParameterServer(center, pull_compress=mode)
    (pa, ta), (pb, tb) = port.pull(), ref.pull()
    assert ta is tb is None
    _assert_same_payload(pa, pb)
    payload, _ = tc.quantize_tree(_tree(6))
    port.commit(payload, commit_id=(0, 0))
    ref.commit(jax.tree.map(np.copy, payload), commit_id=(0, 0))
    _assert_same_payload(port.get_params(), ref.get_params())
    with pytest.raises(ValueError, match="pull_compress must be one of"):
        tps.DynSGDParameterServer(center, pull_compress="float16")


def _mlps():
    jm = jzoo.mnist_mlp(hidden=16)
    tm = zoo.mnist_mlp(hidden=16, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


def _data(n=512):
    from distkeras_tpu.data import loaders as jloaders
    from distkeras_tpu.data import transformers as jtf

    ds = jloaders.synthetic_mnist(n=n, seed=0)
    ds = jtf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    ds = jtf.OneHotTransformer(10, output_col="label_onehot").transform(ds)
    return ds, Dataset({k: ds[k] for k in ds.columns})


def _recording(monkeypatch, mod):
    """Record every commit (id, payload as sent) of ``mod``'s PS class."""
    log = []
    orig = mod.ParameterServer.commit

    def commit(self, delta, *args, **kw):
        log.append((kw.get("commit_id"), jax.tree.map(np.copy, delta)))
        return orig(self, delta, *args, **kw)

    monkeypatch.setattr(mod.ParameterServer, "commit", commit)
    return log


@pytest.mark.parametrize("cls,jcls,kw", [
    (DOWNPOUR, JDOWNPOUR, dict(compress="int8", pull_compress="bfloat16")),
    (DOWNPOUR, JDOWNPOUR, dict(compress="topk:0.05", pull_compress="int8")),
    (AEASGD, JAEASGD, dict(compress="int8")),
    (AEASGD, JAEASGD, dict(compress="topk:0.05")),
], ids=["DOWNPOUR-int8-bf16pull", "DOWNPOUR-topk-int8pull", "AEASGD-int8",
        "AEASGD-topk"])
def test_compressed_trainers_match_jax_commit_by_commit(cls, jcls, kw,
                                                         monkeypatch):
    """4 workers, window 4, 2 epochs (8 commits), ``mnist_mlp(hidden=16)``
    with bridged weights: the same commits in the same order, each
    compressed like JAX's. Int8: codes at most one step apart, on at most
    5e-4 of a commit's elements (a delta differing in its last bits from
    JAX's crosses a rounding boundary), scales within 1e-5 relative.
    Top-k: the same index sets, values within 1e-5 of the commit's
    largest. Per-step losses within 1e-5 relative; centers within 1e-4
    (one int8 step of these deltas is ~2e-5); the error-feedback residual
    (DOWNPOUR) kept, none for the elastic workers, as in JAX."""
    jm, tm = _mlps()
    jds, tds = _data()
    jlog = _recording(monkeypatch, jps)
    tlog = _recording(monkeypatch, tps)
    jt = jcls(jm, "sgd", **ASYNC, **kw)
    jres = jt.train(jds)
    tt = cls(tm, "pallas_sgd", device="cpu", **ASYNC, **kw)
    res = tt.train(tds)
    assert tt.failures == [] and tt.parameter_server.num_updates == 8
    assert [c for c, _ in tlog] == [c for c, _ in jlog] and len(tlog) == 8
    names = tm._leaf_order()
    for (_, a), (_, b) in zip(tlog, jlog):
        if kw["compress"] == "int8":
            assert tc.is_compressed(a) and list(a[tc.Q8_KEY]["q"]) == names
            qa = [a[tc.Q8_KEY]["q"][n].astype(int) for n in names]
            qb = [q.astype(int) for q in jax.tree.leaves(b[jc.Q8_KEY]["q"])]
            assert max(int(np.abs(x - y).max()) for x, y in zip(qa, qb)) <= 1
            off = sum(int((x != y).sum()) for x, y in zip(qa, qb))
            assert off <= 5e-4 * sum(x.size for x in qa)
            np.testing.assert_allclose(
                [a[tc.Q8_KEY]["s"][n] for n in names],
                jax.tree.leaves(b[jc.Q8_KEY]["s"]), rtol=1e-5)
        else:
            assert tc.is_topk(a)
            ia = [a[tc.TOPK_KEY]["i"][n] for n in names]
            ib = jax.tree.leaves(b[jc.TOPK_KEY]["i"])
            assert all(set(x.tolist()) == set(y.tolist())
                       for x, y in zip(ia, ib))
            da = [tc.topk_decompress(a)[n] for n in names]
            db = jax.tree.leaves(jc.topk_decompress(b))
            top = max(float(np.abs(x).max()) for x in db)
            for x, y in zip(da, db):
                np.testing.assert_allclose(x, y, atol=1e-5 * top, rtol=0)
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 32
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for a, b in zip(res.get_weights(), jres.get_weights()):
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0)
    keeps = cls is DOWNPOUR
    assert all((w._q_residual is not None) == keeps for w in tt.workers)


def _compressed_downpour(tm, num_epoch, ck, **kw):
    return DOWNPOUR(tm, "sgd", device="cpu", compress="int8",
                    checkpoint_dir=ck, **{**ASYNC, "num_epoch": num_epoch,
                                          **kw})


def test_compressed_checkpoint_round_trips_the_residual(tmp_path):
    """A compressed DOWNPOUR checkpoint after epoch 1 carries every
    worker's ``q_residual`` bit-equal to the worker's live one (a real
    quantization error, not zeros); the resume restores it, runs exactly
    the second epoch's commits and keeps carrying it. With one worker the
    simulated schedule of a resumed run is the uninterrupted run's, so
    there the resumed run is bit-identical to an uninterrupted one —
    which a lost residual would break at its first commit."""
    ck = str(tmp_path / "ck")
    _, tds = _data()
    first = _compressed_downpour(_mlps()[1], 1, ck)
    first.train(tds)
    n1 = first.parameter_server.num_updates
    _, trees, _ = Checkpointer(ck).restore()
    for w in first.workers:
        saved = trees["workers"][str(w.worker_id)]["q_residual"]
        assert list(saved) == list(w._q_residual)
        for k, v in w._q_residual.items():
            np.testing.assert_array_equal(saved[k], v)
        assert any(np.abs(v).max() > 0 for v in saved.values())
    second = _compressed_downpour(_mlps()[1], 2, ck)
    restored = []
    orig = second.allocate_worker

    def allocate(*args):
        w = orig(*args)
        real = w.restore_snapshot
        w.restore_snapshot = lambda snap: (
            real(snap), restored.append(
                all(np.array_equal(w._q_residual[k], snap["q_residual"][k])
                    for k in snap["q_residual"])))[0]
        return w

    second.allocate_worker = allocate
    second.train(tds, resume=True)
    assert restored == [True] * 4
    assert second.parameter_server.num_updates == 2 * n1
    assert all(w._start_seq > 0 and w._q_residual is not None
               for w in second.workers)

    one = dict(num_workers=1)
    whole = _compressed_downpour(_mlps()[1], 2, str(tmp_path / "w"), **one)
    a = whole.train(tds)
    ck1 = str(tmp_path / "one")
    _compressed_downpour(_mlps()[1], 1, ck1, **one).train(tds)
    resumed = _compressed_downpour(_mlps()[1], 2, ck1, **one)
    b = resumed.train(tds, resume=True)
    assert resumed.parameter_server.num_updates == 8
    for x, y in zip(a.get_weights(), b.get_weights()):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(
        [r["loss"] for r in whole.get_history()][8 * 4 // 2:],
        [r["loss"] for r in resumed.get_history()])
