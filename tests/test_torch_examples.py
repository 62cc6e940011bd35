"""The port's examples as a user runs them. ``examples/mnist_torch.py``:
a subprocess on the CPU (``--device cpu``) at a small ``--n``, through a checkpoint and a resume
that continues where the first invocation stopped, with the metrics rows
and the profiler trace of the resumed run; and BASELINE config 6 on the
real digits. ``examples/serve_lm_torch.py``: export, bundle, serve and
query on the CPU (``--cpu``). The process must not load JAX or the JAX
package."""

import glob
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "examples", "mnist_torch.py")


def run(tmp_path, *args, script=SCRIPT):
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{script!r}, *{list(args)!r}]\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'distkeras_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    return out.stdout


def test_mnist_torch_checkpoint_then_resume(tmp_path):
    ck, metrics, prof = (str(tmp_path / p) for p in ("ck", "m.jsonl", "prof"))
    common = ["--device", "cpu", "--n", "1024", "--checkpoint-dir", ck,
              "--metrics-path", metrics]
    first = run(tmp_path, *common, "--epochs", "1")
    assert "trained 14 steps" in first and "test accuracy:" in first
    assert sorted(os.listdir(ck)) == ["ckpt_0000000001"]
    second = run(tmp_path, *common, "--epochs", "2", "--resume",
                 "--profile-dir", prof)
    # the resumed run trains only epoch 2
    assert "trained 14 steps" in second
    assert sorted(os.listdir(ck)) == ["ckpt_0000000001", "ckpt_0000000002"]
    with open(metrics) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["event"], r.get("epoch")) for r in rows] == [
        ("validation", 1), ("train_end", None),
        ("validation", 2), ("train_end", None)]
    assert len(glob.glob(os.path.join(prof, "trace_*.json"))) == 1


def test_mnist_torch_digits_config_6(tmp_path):
    out = run(tmp_path, "--device", "cpu", "--digits", "--epochs", "2")
    acc = float(out.split("test accuracy:")[1])
    assert "trained 100 steps" in out and acc > 0.5


IMAGENET = os.path.join(REPO, "examples", "imagenet_resnet_torch.py")


def test_imagenet_resnet_torch_from_shards(tmp_path):
    """BASELINE config 5's shape from shards on the CPU, at a smoke size:
    the script writes uint8 shards under ``TMPDIR``, streams them through
    ``.map`` into DynSGD (4 workers, one shard each, seeded simulated
    schedule) and evaluates; each worker commits its one window."""
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{IMAGENET!r}, '--device', 'cpu', '--n', '256',\n"
        "            '--size', '16', '--classes', '10', '--batch', '16',\n"
        "            '--rows-per-shard', '64', '--width', '0.125',\n"
        "            '--mode', 'simulated']\n"
        f"runpy.run_path({IMAGENET!r}, run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'distkeras_tpu')]\n"
        "assert not bad, bad\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path,
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    assert "wrote 4 shards" in out.stdout
    assert "PS updates: 4" in out.stdout and "test accuracy:" in out.stdout


SERVE = os.path.join(REPO, "examples", "serve_lm_torch.py")


def test_serve_lm_torch_export_serve_query(tmp_path):
    out = run(tmp_path, "--cpu", "--epochs", "3", "--temperature", "0.8",
              script=SERVE)
    rows = [json.loads(line.split(":", 1)[1]) for line in out.splitlines()
            if line.startswith("served decode:")]
    assert len(rows) == 4
    vocab = 32
    for row in rows:  # the successor LM counts upward
        assert all((b - a) % vocab == 1 for a, b in zip(row, row[1:])), row
    assert "streamed 10 chunks" in out and "(complete: True)" in out
    assert "replayed identically" in out and "drained and stopped" in out


def test_serve_lm_torch_fleet(tmp_path):
    """--fleet 2 (JAX: ``tests/test_examples.py:140``): two replicas from
    one bundle behind the router, the shared-header requests all served
    by one replica, a rolling upgrade, and the upgraded fleet still
    counting upward."""
    out = run(tmp_path, "--cpu", "--epochs", "3", "--fleet", "2",
              script=SERVE)
    assert "fleet: 2 replicas behind router" in out
    rows = [json.loads(line.split(":", 1)[1]) for line in out.splitlines()
            if line.startswith("served decode")]
    assert len(rows) == 5, out
    for row in rows:
        assert all((b - a) % 32 == 1 for a, b in zip(row[-5:], row[-4:])), row
    assert "served by 1 replica(s)" in out, out
    assert "rollover complete: 2 replicas upgraded" in out
    assert "zero requests dropped" in out
    assert "fleet health: serving, 2 replicas in rotation" in out
    assert "drained and stopped" in out
