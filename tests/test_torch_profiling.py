"""The port's observability pieces vs the JAX package on the CPU: the JSONL
metrics sink (a copy of the JAX module's stdlib code — each side reads
the other's files), the trainers' summary and validation rows, the
per-worker timings, and the ``torch.profiler`` trace behind
``profile_dir``. Mirrors ``tests/test_profiling.py``."""

import glob
import json
import os
import threading

import pytest
import torch

from distkeras_tpu.utils import profiling as jprof
from distkeras_tpu_torch import DOWNPOUR, SingleTrainer, loaders, zoo
from distkeras_tpu_torch.data import transformers as ttf
from distkeras_tpu_torch.utils.history import TrainingHistory
from distkeras_tpu_torch.utils.profiling import (
    MetricsLogger,
    annotate,
    read_metrics,
    rotated_segments,
    trace,
)

torch.set_num_threads(2)


def make_data(n=512):
    ds = loaders.synthetic_mnist(n=n, seed=0)
    ds = ttf.MinMaxTransformer(0, 1, o_min=0, o_max=255).transform(ds)
    return ttf.OneHotTransformer(10, output_col="label_onehot").transform(ds)


def single(**kw):
    return SingleTrainer(zoo.mnist_mlp(hidden=16, device="cpu"), "sgd",
                         "categorical_crossentropy", learning_rate=0.05,
                         batch_size=64, num_epoch=1, label_col="label_onehot",
                         device="cpu", **kw)


def test_metrics_logger_jsonl_and_cross_reads(tmp_path):
    path = str(tmp_path / "m.jsonl")
    with MetricsLogger(path) as log:
        log.log(event="a", x=1)
        log.log(event="b", y=2.5)
    records = read_metrics(path)
    assert [r["event"] for r in records] == ["a", "b"]
    assert records[0]["x"] == 1 and "ts" in records[0]
    assert jprof.read_metrics(path) == records
    other = str(tmp_path / "j.jsonl")
    jprof.MetricsLogger(other, max_bytes=120, keep=2).log(event="c")
    assert [r["event"] for r in read_metrics(other)] == ["c"]


def test_metrics_logger_thread_safe(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path)

    def write(i):
        for j in range(50):
            log.log(event="tick", worker=i, j=j)

    threads = [threading.Thread(target=write, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert len(read_metrics(path)) == 400  # every line parses


def test_read_metrics_tolerates_truncated_final_line(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path)
    log.log(event="a", x=1)
    log.log(event="b", x=2)
    with open(path, "a") as f:
        f.write('{"ts": 3, "event": "c", "x"')  # crash mid-append
    assert [r["event"] for r in read_metrics(path)] == ["a", "b"]
    with pytest.raises(json.JSONDecodeError):
        read_metrics(path, strict=True)
    bad = str(tmp_path / "bad.jsonl")
    with open(bad, "w") as f:
        f.write('{"event": "a"}\n{torn\n{"event": "b"}\n')
    with pytest.raises(json.JSONDecodeError):
        read_metrics(bad)


def test_metrics_logger_size_bounded_rotation(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path, max_bytes=200, keep=3)
    for i in range(60):
        log.log(event="tick", i=i)
    assert log.rotations > 3
    segs = rotated_segments(path)
    assert [os.path.basename(s) for s in segs] == [
        "m.jsonl.3", "m.jsonl.2", "m.jsonl.1", "m.jsonl"]
    assert all(os.path.getsize(s) <= 200 for s in segs)
    idx = [r["i"] for r in read_metrics(path)]
    assert idx == sorted(idx) and idx[-1] == 59 and 0 < len(idx) < 60
    assert jprof.rotated_segments(path) == segs
    with pytest.raises(ValueError):
        MetricsLogger(path, max_bytes=0)
    with pytest.raises(ValueError):
        MetricsLogger(path, keep=0)


def test_read_metrics_rotated_torn_tail_semantics(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path, max_bytes=120, keep=2)
    for i in range(12):
        log.log(event="tick", i=i)
    with open(path, "a") as f:
        f.write('{"ts": 3, "event": "c", "i"')
    records = read_metrics(path)
    assert records and records[-1]["event"] == "tick"
    with pytest.raises(json.JSONDecodeError):
        read_metrics(path, strict=True)
    with open(path + ".1", "a") as f:
        f.write('{"torn')
    with pytest.raises(json.JSONDecodeError):
        read_metrics(path)


def test_metrics_logger_repairs_torn_tail_on_reopen(tmp_path):
    path = str(tmp_path / "m.jsonl")
    log = MetricsLogger(path, max_bytes=120, keep=2)
    for i in range(3):
        log.log(event="before", i=i)
    with open(path, "a") as f:
        f.write('{"ts": 3, "event": "c", "i"')
    log2 = MetricsLogger(path, max_bytes=120, keep=2)
    for i in range(8):
        log2.log(event="after", i=i)
    records = read_metrics(path)
    events = [r["event"] for r in records]
    assert "c" not in events and events[-1] == "after"
    assert read_metrics(path, strict=True) == records


def test_history_throughput():
    h = TrainingHistory()
    h.record_training_start()
    h.record_window(0, 100, 0.5)
    h.record_window(1, 300, 0.5)
    h.record_training_end()
    assert h.total_samples() == 400 and len(h.get_timings(0)) == 1
    assert h.samples_per_second() > 0


def test_single_trainer_logs_summary_and_validation(tmp_path):
    ds = make_data()
    path = str(tmp_path / "train.jsonl")
    t = single(metrics_path=path, validation_data=make_data(64))
    t.train(ds)
    val, rec = read_metrics(path)
    assert val["event"] == "validation" and val["epoch"] == 1
    assert val["val_loss"] == pytest.approx(
        t.get_validation_history()[0]["val_loss"])
    assert rec["event"] == "train_end" and rec["trainer"] == "SingleTrainer"
    assert rec["total_samples"] == (len(ds) // 64) * 64
    assert rec["num_updates"] == len(ds) // 64
    assert rec["samples_per_sec"] > 0
    assert "avg_loss" in rec and "avg_accuracy" in rec
    assert t.history.total_samples() == rec["total_samples"]


def test_downpour_records_per_worker_timings(tmp_path):
    t = DOWNPOUR(zoo.mnist_mlp(hidden=16, device="cpu"), "sgd",
                 "categorical_crossentropy", learning_rate=0.05,
                 batch_size=32, num_workers=2, communication_window=2,
                 num_epoch=1, mode="simulated", label_col="label_onehot",
                 metrics_path=str(tmp_path / "dp.jsonl"), device="cpu")
    t.train(make_data(256))
    assert t.history.get_timings(0) and t.history.get_timings(1)
    (rec,) = read_metrics(str(tmp_path / "dp.jsonl"))
    assert rec["trainer"] == "DOWNPOUR" and rec["total_samples"] == 256


def test_profile_trace_writes_a_chrome_trace(tmp_path):
    prof = str(tmp_path / "prof")
    t = single(profile_dir=prof)
    t.train(make_data(128))
    (path,) = glob.glob(f"{prof}/trace_*.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any("aten::mm" in n or "aten::addmm" in n for n in names)


def test_trace_and_annotate_outside_a_trainer(tmp_path):
    with trace(str(tmp_path / "t")):
        with annotate("pull"):
            torch.ones(4).sum()
    (path,) = glob.glob(str(tmp_path / "t" / "trace_*.json"))
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "pull" in names
    with annotate("outside a trace"):
        pass
