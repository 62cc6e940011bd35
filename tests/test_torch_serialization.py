"""The port's pickle-free tree codec vs the JAX package's on the CPU.

The frames carry an npz payload, whose zip entries hold the time they were
written (to two seconds); the byte-equality tests fix the clock so both
encoders stamp the same time. Everything else mirrors
``tests/test_serialization.py``: round trips, the namedtuple allowlist,
the refusal of pickle bytes and of non-numeric leaves — and each side
decodes the other's frames.
"""

import collections
import pickle
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from distkeras_tpu.utils import serialization as jser
from distkeras_tpu_torch.utils import serialization as tser


@pytest.fixture
def fixed_clock(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_760_000_000.0)


def _optax_state():
    params = {"w": jnp.ones((3, 2)), "b": jnp.zeros(2)}
    return jax.tree.map(np.asarray, optax.adam(1e-3).init(params))


def _plain_tree():
    rng = np.random.default_rng(0)
    return {"layers": [{"w": rng.standard_normal((2, 3)).astype(np.float32),
                        "b": np.zeros(3)}, None],
            "count": np.int32(7), "flags": (np.array([True, False]),)}


@pytest.mark.parametrize("make", [_plain_tree, _optax_state],
                         ids=["plain", "optax_namedtuples"])
def test_bytes_equal_the_jax_encoder(fixed_clock, make):
    tree = make()
    assert tser.serialize_params(tree) == jser.serialize_params(tree)


def test_tensor_leaves_encode_as_their_arrays(fixed_clock):
    tree = {"w": np.arange(6, dtype=np.float32).reshape(2, 3),
            "c": np.int32(3)}
    as_tensors = {"w": torch.from_numpy(tree["w"]),
                  "c": torch.tensor(3, dtype=torch.int32)}
    assert tser.serialize_params(as_tensors) == jser.serialize_params(tree)
    with pytest.raises(TypeError, match="bfloat16"):
        tser.serialize_params({"w": torch.ones(2, dtype=torch.bfloat16)})


def test_each_side_decodes_the_others_frames():
    state = _optax_state()
    port = tser.deserialize_params(jser.serialize_params(state))
    # optax is not on the port's allowlist: the states come back as
    # anonymous namedtuples with optax's class names and fields
    assert type(port[0]).__name__ == "ScaleByAdamState"
    assert port[0]._fields == ("count", "mu", "nu")
    assert type(port[0]).__module__ != "optax._src.transform"
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(tuple(port))):
        np.testing.assert_array_equal(a, b)
    # the JAX side decodes the port's frame; the anonymous classes now
    # name the port's decoder as their module, so it degrades them as well:
    # the same fields and leaves
    back = jser.deserialize_params(tser.serialize_params(port))
    assert back[0]._fields == state[0]._fields
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(tuple(back))):
        np.testing.assert_array_equal(a, b)
    plain = _plain_tree()
    jout = jser.deserialize_params(tser.serialize_params(plain))
    assert jax.tree.structure(jout) == jax.tree.structure(plain)
    out = tser.deserialize_params(jser.serialize_params(plain))
    assert out["layers"][1] is None and isinstance(out["flags"], tuple)
    assert out["layers"][0]["b"].dtype == np.float64
    np.testing.assert_array_equal(out["layers"][0]["w"],
                                  plain["layers"][0]["w"])


def test_save_and_load_params(tmp_path):
    path = str(tmp_path / "p.tree")
    tser.save_params(path, {"w": torch.ones(2, 2)})
    out = tser.load_params(path)
    np.testing.assert_array_equal(out["w"], np.ones((2, 2), np.float32))
    np.testing.assert_array_equal(jser.load_params(path)["w"], out["w"])


def test_port_namedtuple_comes_back_and_foreign_degrades():
    Own = collections.namedtuple("Own", ["x"])
    Own.__module__ = "collections"  # allowlisted root, but no such class
    out = tser.deserialize_params(tser.serialize_params(Own(np.ones(2))))
    assert type(out).__name__ == "Own" and out._fields == ("x",)
    Foreign = collections.namedtuple("Foreign", ["x", "y"])
    Foreign.__module__ = "os.path"
    out = tser.deserialize_params(
        tser.serialize_params(Foreign(np.ones(2), np.zeros(2))))
    assert type(out).__name__ == "Foreign"
    assert type(out).__module__ != "os.path"
    np.testing.assert_array_equal(out.x, np.ones(2))


def test_malicious_class_path_not_imported():
    header, payload = tser.unpack_frame(tser.serialize_params((np.ones(1),)))
    evil = {"t": "nt", "cls": "subprocess:Popen", "fields": ["args"],
            "children": [header["tree"]["children"][0]]}
    out = tser.deserialize_params(tser.pack_frame({"tree": evil}, payload))
    assert type(out).__name__ == "Popen" and isinstance(out, tuple)
    assert not hasattr(out, "communicate")


def test_pickle_bytes_refused_and_none_written():
    with pytest.raises(ValueError, match="magic"):
        tser.deserialize_params(pickle.dumps({"treedef": None, "npz": b""}))
    blob = tser.serialize_params({"w": np.ones((4, 4))})
    assert blob[:4] == b"DKT1"
    with pytest.raises(pickle.UnpicklingError):
        pickle.loads(blob)


def test_non_numeric_leaf_rejected():
    with pytest.raises(TypeError, match="not serializable"):
        tser.serialize_params({"fn": np.array([print], dtype=object)})
    with pytest.raises(TypeError, match="str-keyed"):
        tser.serialize_params({1: np.ones(1)})
