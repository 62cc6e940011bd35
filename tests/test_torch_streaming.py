"""The PyTorch port's streaming dataset (``distkeras_tpu_torch.data.
streaming``) vs the JAX package's on the CPU.

Shards written by either package open in the other, and for the same seed
both yield the same batches in the same order — across shard seams, after
``shuffle``, per ``partition`` and through ``map``. The batches are
compared bit for bit (both sides are the same numpy). Trainers fed from
shards are compared with the JAX trainers on the same shards at the
tolerances of ``tests/test_torch_async.py``.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from distkeras_tpu import DOWNPOUR as JDOWNPOUR
from distkeras_tpu import SingleTrainer as JSingleTrainer
from distkeras_tpu.data import streaming as jst
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu.models import zoo as jzoo
from distkeras_tpu_torch import (
    DOWNPOUR,
    ShardWriter,
    SingleTrainer,
    StreamingDataset,
    open_shards,
    write_shards,
    zoo,
)
from distkeras_tpu_torch.data import streaming as tst
from distkeras_tpu_torch.data.dataset import Dataset
from distkeras_tpu_torch.utils.convert import params_from_jax

torch.set_num_threads(2)


@pytest.fixture(autouse=True)
def _uncached_jax_cores(monkeypatch):
    """Uncached JAX cores (``DKT_DISABLE_CORE_CACHE``), so no later JAX
    test in this process is handed one of these runs' cores."""
    monkeypatch.setenv("DKT_DISABLE_CORE_CACHE", "1")


def _columns(n=203, d=6, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "features": rng.standard_normal((n, d)).astype(np.float32),
        "label": rng.integers(0, 10, n),
        "image": rng.integers(0, 256, (n, 2, 3), dtype=np.uint8),
    }


def _write(pkg, cols, out, rows_per_shard=32):
    """Shards of ``cols`` under ``out`` written by the port or by JAX."""
    if pkg == "port":
        return write_shards(Dataset(cols), out, rows_per_shard)
    return jst.write_shards(JDataset(cols), out, rows_per_shard)


def _batches(ds, *args, **kw):
    return list(ds.batches(*args, **kw))


def _assert_same_batches(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert sorted(x) == sorted(y)
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_shards_round_trip_across_implementations(writer, tmp_path):
    """Shards one package writes open in the other: the same sidecar, row
    counts, columns and arrays, dtypes kept (uint8 stays uint8)."""
    cols = _columns()
    out = str(tmp_path / "s")
    paths = _write(writer, cols, out)
    assert len(paths) == 7 and all(os.path.exists(p) for p in paths)
    with open(os.path.join(out, "shards.json")) as f:
        meta = json.load(f)
    assert meta["rows"] == [32] * 6 + [11]
    assert meta["columns"] == ["features", "image", "label"]
    port, ref = open_shards(out), jst.open_shards(out)
    assert isinstance(port, StreamingDataset)
    assert len(port) == len(ref) == 203
    assert port.columns == ref.columns == meta["columns"]
    full = _batches(port, 203)
    _assert_same_batches(full, _batches(ref, 203))
    for k, v in cols.items():
        np.testing.assert_array_equal(full[0][k], v)
    # the same directory opened without its sidecar: rows from the npy
    # headers
    os.remove(os.path.join(out, "shards.json"))
    assert tst.open_shards(out)._rows == jst.open_shards(out)._rows


@pytest.mark.parametrize("seed", [None, 0, 5], ids=["ordered", "seed0",
                                                    "seed5"])
@pytest.mark.parametrize("batch,drop", [(8, True), (24, True), (24, False),
                                        (50, False)])
def test_batch_order_matches_jax(seed, batch, drop, tmp_path):
    """For the same seed, the same batches in the same order: shard order
    and rows within a shard permuted by the one generator, remainders
    carried across shard seams (24 and 50 straddle the 32-row shards),
    only the final global remainder dropped (or yielded)."""
    out = str(tmp_path / "s")
    _write("jax", _columns(), out)
    port, ref = open_shards(out), jst.open_shards(out)
    if seed is not None:
        port, ref = port.shuffle(seed), ref.shuffle(seed)
    a = _batches(port, batch, drop_remainder=drop)
    _assert_same_batches(a, _batches(ref, batch, drop_remainder=drop))
    assert len(a) == port.num_batches(batch, drop) == ref.num_batches(batch,
                                                                      drop)
    assert all(len(b["label"]) == batch for b in a[:203 // batch])
    rows = np.concatenate([b["label"] for b in a])
    assert len(rows) == (203 // batch * batch if drop else 203)
    if seed is None:
        np.testing.assert_array_equal(rows, _columns()["label"][:len(rows)])


def test_partition_map_and_columns_match_jax(tmp_path):
    """``partition`` deals whole shards round-robin (shards 0, 3, 6 to the
    first of three parts); ``map`` runs per loaded chunk and may rename
    columns; ``columns`` needs no chunk without transforms. Each part,
    shuffled per part, yields JAX's batches."""
    out = str(tmp_path / "s")
    _write("port", _columns(), out)

    def prep(c):
        return {"x": c["features"] * 2.0, "label": c["label"],
                "onehot": np.eye(10, dtype=np.float32)[c["label"]]}

    port = open_shards(out).shuffle(3).map(prep)
    ref = jst.open_shards(out).shuffle(3).map(prep)
    assert port.columns == ref.columns == ["label", "onehot", "x"]
    parts, rparts = port.partition(3), ref.partition(3)
    assert [len(p) for p in parts] == [len(p) for p in rparts] == [75, 64, 64]
    assert [os.path.basename(p) for p in parts[0]._paths] == [
        "shard_00000.npz", "shard_00003.npz", "shard_00006.npz"]
    for p, r in zip(parts, rparts):
        _assert_same_batches(_batches(p, 16, columns=["x", "onehot"]),
                             _batches(r, 16, columns=["x", "onehot"]))
        _assert_same_batches(_batches(p.shuffle(9), 16),
                             _batches(r.shuffle(9), 16))
    with pytest.raises(ValueError, match="8 workers need >= 8 shards"):
        port.partition(8)
    with pytest.raises(ValueError, match="8 workers need >= 8 shards"):
        ref.partition(8)


def test_shard_writer_contract(tmp_path):
    """``ShardWriter`` appends one shard per ``add`` and publishes the
    sidecar on close; ragged or mismatched columns, no shards and a
    non-positive shard size are refused as in JAX."""
    out = str(tmp_path / "w")
    with ShardWriter(out) as w:
        w.add({"a": np.arange(5), "b": np.ones((5, 2), np.float32)})
        w.add({"b": np.zeros((3, 2), np.float32), "a": np.arange(3)})
    ds = open_shards(out)
    assert len(ds) == 8 and ds._rows == [5, 3]
    np.testing.assert_array_equal(next(ds.batches(8))["a"],
                                  np.r_[np.arange(5), np.arange(3)])
    for cls in (ShardWriter, jst.ShardWriter):
        writer = cls(str(tmp_path / cls.__module__))
        writer.add({"a": np.arange(2)})
        with pytest.raises(ValueError, match="first shard"):
            writer.add({"c": np.arange(2)})
        with pytest.raises(ValueError, match="length mismatch"):
            cls(str(tmp_path / "ragged")).add({"a": np.arange(2),
                                              "b": np.arange(3)})
    with pytest.raises(ValueError, match="no shards"):
        ShardWriter(str(tmp_path / "z")).close()
    with pytest.raises(ValueError, match="positive"):
        write_shards({"a": np.arange(4)}, str(tmp_path / "q"), 0)
    with pytest.raises(FileNotFoundError):
        open_shards(str(tmp_path / "z"))


def _mnist(n):
    """``synthetic_mnist`` as the JAX package builds it (features scaled,
    one-hot labels); the port's loaders give the same arrays
    (``tests/test_torch_async.py``)."""
    from distkeras_tpu.data import loaders as jloaders
    from distkeras_tpu.data import transformers as jtf

    ds = jloaders.synthetic_mnist(n=n, seed=0)
    ds = jtf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return jtf.OneHotTransformer(10, output_col="label_onehot").transform(ds)


def _mlps():
    jm = jzoo.mnist_mlp(hidden=16)
    tm = zoo.mnist_mlp(hidden=16, device="cpu")
    params_from_jax(tm, jax.tree.map(np.asarray, jm.params))
    return jm, tm


def test_single_trainer_from_shards_matches_jax_and_in_memory(tmp_path):
    """``SingleTrainer`` fed from shards (prefetch 2, shuffled per epoch
    through the stream's own shuffle): every step's loss within 1e-5
    relative of the JAX trainer on the same shards and the weights within
    1e-5 (the matmul summation order differs). Unshuffled, the stream
    yields the in-memory dataset's batches, so the port's two runs are
    bit-identical."""
    ds = _mnist(640)
    out = str(tmp_path / "s")
    jst.write_shards(ds, out, rows_per_shard=100)
    kw = dict(loss="categorical_crossentropy", learning_rate=0.05,
              batch_size=32, num_epoch=2, window=4,
              label_col="label_onehot", seed=0)
    jm, tm = _mlps()
    jt = JSingleTrainer(jm, "sgd", prefetch=2, **kw)
    jres = jt.train(jst.open_shards(out), shuffle=True)
    tt = SingleTrainer(tm, "sgd", prefetch=2, device="cpu", **kw)
    tres = tt.train(open_shards(out), shuffle=True)
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 40
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for a, b in zip(tres.get_weights(), jres.get_weights()):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)
    cols = {k: ds[k] for k in ds.columns}
    mem = SingleTrainer(_mlps()[1], "sgd", device="cpu", **kw).train(
        Dataset(cols))
    streamed = SingleTrainer(_mlps()[1], "sgd", device="cpu", **kw).train(
        open_shards(out))
    for a, b in zip(mem.get_weights(), streamed.get_weights()):
        np.testing.assert_array_equal(a, b)


def test_async_trainer_partitions_shards_like_jax(tmp_path):
    """DOWNPOUR in simulated mode over 8 shards: each of the 4 workers
    streams its own 2 shards; the same commits as the JAX trainer on the
    same shards (losses within 1e-5 relative, centers within 1e-5)."""
    out = str(tmp_path / "s")
    jst.write_shards(_mnist(512), out, rows_per_shard=64)
    kw = dict(loss="categorical_crossentropy", learning_rate=0.02,
              batch_size=32, num_epoch=2, num_workers=4,
              communication_window=4, label_col="label_onehot",
              mode="simulated", seed=0)
    jm, tm = _mlps()
    jt = JDOWNPOUR(jm, "sgd", **kw)
    jres = jt.train(jst.open_shards(out), shuffle=True)
    tt = DOWNPOUR(tm, "pallas_sgd", device="cpu", **kw)
    tres = tt.train(open_shards(out), shuffle=True)
    assert tt.failures == []
    assert tt.parameter_server.num_updates == jt.parameter_server.num_updates
    assert tt.parameter_server.num_updates == 8
    jh, th = jt.get_history(), tt.get_history()
    assert len(th) == len(jh) == 32
    for a, b in zip(jh, th):
        np.testing.assert_allclose(b["loss"], a["loss"], rtol=1e-5)
    for a, b in zip(tres.get_weights(), jres.get_weights()):
        np.testing.assert_allclose(a, b, atol=1e-5, rtol=0)


def test_device_resident_refuses_a_stream(tmp_path):
    """``device_resident=True`` with a stream raises the JAX package's
    TypeError, from ``SingleTrainer`` and from the async trainers."""
    out = str(tmp_path / "s")
    jst.write_shards(_mnist(256), out, 64)
    kw = dict(loss="categorical_crossentropy", batch_size=32,
              label_col="label_onehot", device_resident=True, device="cpu")
    _, tm = _mlps()
    for trainer in (SingleTrainer(tm, "sgd", **kw),
                    DOWNPOUR(tm, "sgd", num_workers=2, mode="simulated",
                             **kw)):
        with pytest.raises(TypeError, match="requires an in-memory Dataset"):
            trainer.train(open_shards(out))
