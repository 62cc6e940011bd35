"""The port's quantization entry points, model frames and serving bundles
against the JAX package: ``quantize_params`` bit for bit on the same f32
tree, ``serialize_model``/``deserialize_model`` and the serving bundles
written by either package and read by the other, the refusals, the
bundle validation, and ``ServingEngine.from_bundle`` decoding what JAX's
``from_bundle`` engine decodes."""

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu.ops import quantization as jq
from distkeras_tpu.predictors import CachedSequenceGenerator as JCached
from distkeras_tpu.serving import ServingEngine as JEngine
from distkeras_tpu.utils import serialization as js
from distkeras_tpu_torch.models import zoo
from distkeras_tpu_torch.ops import quantization as tq
from distkeras_tpu_torch.ops.fused_layernorm import attach_fused_layernorm
from distkeras_tpu_torch.predictors import CachedSequenceGenerator
from distkeras_tpu_torch.serving import ServingEngine
from distkeras_tpu_torch.utils import serialization as ts
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)

LM = dict(vocab_size=61, seq_len=64, d_model=128, num_heads=2, depth=2)


@pytest.fixture(scope="module")
def lms():
    jlm = jzoo.transformer_lm(**LM, seed=0)
    lm = zoo.transformer_lm(**LM, device="cpu")
    params_from_jax(lm, jax.tree.map(np.asarray, jlm.params))
    return jlm, lm


def _np(tree):
    """A quantized params tree as numpy, either package's leaves."""
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if hasattr(tree, "q4"):
        return {"q4": _np(tree.q4), "s": _np(tree.s), "rows": tree.rows}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def _assert_trees_equal(a, b, path="params"):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, int):
        assert a == b, path
    else:
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)


# --------------------------------------------------------- quantization


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_params_equals_jax_bit_for_bit(lms, bits):
    jlm, lm = lms
    f32 = jax.tree.map(np.asarray, jlm.params)
    ours = tq.quantize_params(f32, bits=bits)
    theirs = jq.quantize_params(jlm.params, bits=bits)
    _assert_trees_equal(_np(ours), _np(theirs))
    assert tq.count_quantized(ours) == jq.count_quantized(theirs) == 13
    # the port model's own tree quantizes to the same numbers
    _assert_trees_equal(_np(tq.quantize_params(tq.params_tree(lm),
                                               bits=bits)), _np(theirs))
    # idempotent: a quantized tree is not re-quantized at another width
    assert tq.quantize_params(ours, bits=12 - bits)["1"]["mhsa"]["wq"] is \
        ours["1"]["mhsa"]["wq"]


def test_quantize_params_keys_and_refusals():
    tree = {"kernel": np.ones((3, 4), np.float32),
            "bias": np.ones((4,), np.float32),
            "wq": np.ones((4, 4), np.int32),
            "sub": [{"kernel": torch.ones(2, 2)}],
            "emb": np.ones((5, 3), np.float32)}
    out = tq.quantize_params(tree)
    assert tq.is_quantized(out["kernel"]) and tq.is_quantized(
        out["sub"][0]["kernel"])
    for k in ("bias", "wq", "emb"):
        assert out[k] is tree[k]
    assert tq.count_quantized(out) == 2
    assert tq.count_quantized(tq.quantize_params(tree, keys=("emb",))) == 1
    with pytest.raises(ValueError, match="bits"):
        tq.quantize_params(tree, bits=3)


def test_quantize_model_swaps_weights_in_place(lms):
    jlm, lm = lms
    m = tq.quantize_model(lm.copy())
    assert tq.count_quantized(m) == 13 and tq.count_quantized(lm) == 0
    assert not any(n.endswith(("wq", "kernel"))
                   for n, _ in m.named_parameters())
    _assert_trees_equal(_np(tq.params_tree(m)),
                        _np(jq.quantize_params(jlm.params)))
    with pytest.raises(ValueError, match="BUILT"):
        tq.quantize_model(zoo.Sequential([]))


# --------------------------------------------------------- model frames


def test_model_frames_load_in_either_package(lms):
    jlm, lm = lms
    m = ts.deserialize_model(js.serialize_model(jlm), device="cpu")
    for a, b in zip(m.get_weights(), jlm.get_weights()):
        np.testing.assert_array_equal(a, np.asarray(b))
    assert m.input_shape == tuple(jlm.input_shape)
    jm = js.deserialize_model(ts.serialize_model(lm))
    for a, b in zip(jm.get_weights(), lm.get_weights()):
        np.testing.assert_array_equal(np.asarray(a), b)
    x = np.random.default_rng(0).integers(0, 61, (2, 64)).astype(np.int32)
    np.testing.assert_allclose(m(torch.as_tensor(x)).detach().numpy(),
                               np.asarray(jm(x)), atol=1e-4, rtol=0)


def test_refusals_keep_the_formats_apart(lms):
    jlm, lm = lms
    q = tq.quantize_model(lm.copy())
    with pytest.raises(ValueError, match="quantized"):
        ts.serialize_model(q)
    bundle = ts.serialize_serving_bundle(q)
    with pytest.raises(ValueError, match="SERVING bundle"):
        ts.deserialize_model(bundle)
    with pytest.raises(ValueError, match="SERVING bundle"):
        js.deserialize_model(bundle)
    with pytest.raises(ValueError, match="not quantized"):
        ts.serialize_serving_bundle(lm)
    with pytest.raises(ValueError, match="not a serving bundle"):
        ts.deserialize_serving_bundle(ts.serialize_model(lm), device="cpu")
    with pytest.raises(ValueError, match="BUILT"):
        ts.serialize_serving_bundle(zoo.Sequential([]))


# ------------------------------------------------------ serving bundles


@pytest.mark.parametrize("bits", [8, 4])
def test_bundles_load_in_either_package(lms, bits, tmp_path):
    jlm, lm = lms
    jbundle = js.serialize_serving_bundle(jq.quantize_model(jlm.copy(),
                                                            bits=bits))
    ours = ts.deserialize_serving_bundle(jbundle, device="cpu")
    _assert_trees_equal(_np(tq.params_tree(ours)),
                        _np(jq.quantize_params(jlm.params, bits=bits)))
    path = tmp_path / "port.dkt"
    ts.save_serving_bundle(str(path), tq.quantize_model(lm.copy(), bits=bits))
    theirs = js.load_serving_bundle(str(path))
    _assert_trees_equal(_np(theirs.params),
                        _np(jq.quantize_params(jlm.params, bits=bits)))
    again = ts.load_serving_bundle(str(path), device="cpu")
    _assert_trees_equal(_np(tq.params_tree(again)), _np(tq.params_tree(ours)))


def _tampered(blob, edit):
    """Re-encode a bundle with ``edit`` applied to its params tree."""
    header, payload = ts.unpack_frame(blob)
    tree = ts.deserialize_params(payload)
    edit(tree)
    return ts.pack_frame(header, ts.serialize_params(tree))


@pytest.mark.parametrize("edit,match", [
    (lambda t: t["1"]["mhsa"]["wq"].update(s=np.ones(1, np.float32)),
     "int8 internals"),
    (lambda t: t["1"]["mhsa"]["wq"].update(
        q=t["1"]["mhsa"]["wq"]["q"].astype(np.int32)), "int8 internals"),
    (lambda t: t["1"]["mhsa"].update(bo=np.zeros(128, np.float64)),
     "dtype mismatch"),
    (lambda t: t["1"]["mhsa"].update(bo=np.zeros(127, np.float32)),
     "shape mismatch"),
    (lambda t: t["1"].pop("ln1"), "structure mismatch"),
    (lambda t: t["1"]["mhsa"].update(
        bo={"q": np.zeros((1, 128), np.int8), "s": np.ones(128, np.float32)}),
     "structure mismatch"),
    (lambda t: t["1"]["mhsa"]["wq"].update(q=np.zeros((4, 4), np.int8)),
     "shape mismatch"),
])
def test_bundle_validation_refuses_like_jax(lms, edit, match):
    jlm, lm = lms
    blob = _tampered(ts.serialize_serving_bundle(
        tq.quantize_model(lm.copy())), edit)
    with pytest.raises(ValueError, match=match):
        ts.deserialize_serving_bundle(blob, device="cpu")
    with pytest.raises(ValueError, match=match):
        js.deserialize_serving_bundle(blob)


def test_int4_bundle_internals_are_validated(lms):
    _, lm = lms
    blob = ts.serialize_serving_bundle(tq.quantize_model(lm.copy(), bits=4))

    def edit(t):
        w = t["1"]["mhsa"]["wq"]
        w.q4 = w.q4[:-1]

    with pytest.raises(ValueError, match="int4 internals"):
        ts.deserialize_serving_bundle(_tampered(blob, edit), device="cpu")


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_from_bundle_engines_decode_alike(lms, writer, tmp_path):
    """A bundle written by either package: the port's ``from_bundle``
    engine equals JAX's ``from_bundle`` engine token for token, and the
    port's solo decode of the loaded model."""
    jlm, lm = lms
    path = str(tmp_path / "lm_int8.dkt")
    if writer == "jax":
        js.save_serving_bundle(path, jq.quantize_model(jlm.copy()))
    else:
        ts.save_serving_bundle(path, tq.quantize_model(lm.copy()))
    rng = np.random.default_rng(7)
    prompts = [rng.integers(0, 61, n).astype(np.int32) for n in (5, 19, 11)]
    eng = ServingEngine.from_bundle(path, num_slots=2, prefill_chunk=8,
                                    device="cpu")
    attach_fused_layernorm(eng.model)
    jeng = JEngine.from_bundle(path, num_slots=2, prefill_chunk=8)
    eng.start()
    jeng.start()
    try:
        ours = [eng.wait(r, timeout=60)
                for r in [eng.submit(p, 10) for p in prompts]]
        theirs = [jeng.wait(r, timeout=60)
                  for r in [jeng.submit(p, 10) for p in prompts]]
    finally:
        eng.stop()
        jeng.stop()
    assert tq.count_quantized(eng.model) == 13
    solo = CachedSequenceGenerator(eng.model, device="cpu")
    jsolo = JCached(jq.quantize_model(jlm.copy()))
    for p, a, b in zip(prompts, ours, theirs):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, solo.generate(p[None], 10)[0])
        np.testing.assert_array_equal(
            a, np.asarray(jsolo.generate(p[None], 10))[0])


def test_from_bundle_defaults_to_cuda(lms, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, lm = lms
    path = str(tmp_path / "b.dkt")
    ts.save_serving_bundle(path, tq.quantize_model(lm.copy()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServingEngine.from_bundle(path)
