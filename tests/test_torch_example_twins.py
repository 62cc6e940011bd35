"""The port's twins of the JAX examples, run as a user runs them.

Each case is a subprocess of ``examples/<name>_torch.py --cpu`` at a small
size, through ``runpy`` so that the process can assert it loaded neither
JAX nor the JAX package (the check of ``tests/test_torch_examples.py``).
The assertions mirror ``tests/test_examples.py``: the same result lines,
``real_digits`` above 0.9 held-out accuracy, the language model's int8
bundle and speculative cases counting upward. The twins JAX does not test
get a case each, the modes that launch rank processes (``sync``,
``--seq-parallel``) at two gloo ranks. Without ``--cpu`` on a machine
with no card every twin exits non-zero with the device contract's
message.
"""

import json
import os
import signal
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TWINS = ("cifar10", "diabetes_regression", "higgs_workflow",
         "language_model", "long_context", "mnist", "optimizer_comparison",
         "real_digits")


def _code(name, args):
    script = os.path.join(REPO, "examples", f"{name}_torch.py")
    return (
        "import runpy, sys\n"
        f"sys.argv = [{script!r}, *{list(args)!r}]\n"
        f"runpy.run_path({script!r}, run_name='__main__')\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'distkeras_tpu')]\n"
        "assert not bad, bad\n"
    )


def _run(cwd, name, args, timeout=120, env=None):
    """The twin in a session of its own: past ``timeout`` the whole
    process group goes, the rank processes the twin launched included.
    Each process of the twin gets two threads (unless the caller set
    ``OMP_NUM_THREADS``): the twin shares the host with the other test
    workers, and threads spinning on every core starve them all."""
    env = dict(os.environ if env is None else env)
    env.setdefault("OMP_NUM_THREADS", "2")
    proc = subprocess.Popen([sys.executable, "-c", _code(name, args)],
                            cwd=cwd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.communicate()
        raise
    return subprocess.CompletedProcess(proc.args, proc.returncode, out, err)


def run_twin(tmp_path, name, *args, timeout=120):
    out = _run(tmp_path, name, args, timeout)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-3000:])
    return out.stdout


def _value(out, marker):
    return float(out.rsplit(marker, 1)[1].split()[0])


def _counting(out):
    rows = [line for line in out.splitlines()
            if line.startswith("greedy decode:")]
    for line in rows:
        toks = json.loads(line.split(":", 1)[1])
        assert toks[-5:] == list(range(toks[-5], toks[-5] + 5)), toks
    return rows


def test_real_digits_single_int8(tmp_path):
    out = run_twin(tmp_path, "real_digits", "--cpu", "--int8")
    assert _value(out, "REAL holdout accuracy") > 0.9, out
    assert _value(out, "int8 serving copy: REAL holdout accuracy") > 0.9


def test_real_digits_sync_two_ranks(tmp_path):
    out = run_twin(tmp_path, "real_digits", "sync", "--cpu", "--workers", "2",
                   "--epochs", "4")
    assert "sync: 2 rank processes over gloo on the CPU" in out
    assert _value(out, "REAL holdout accuracy") > 0.9, out


def test_real_digits_downpour(tmp_path):
    out = run_twin(tmp_path, "real_digits", "downpour", "--cpu",
                   "--workers", "2", "--epochs", "3")
    assert out.count("REAL holdout accuracy") == 1, out


@pytest.mark.parametrize("mode", ["single", "sync"])
def test_diabetes_regression(tmp_path, mode):
    args = ["--cpu"] + (["sync", "--workers", "2", "--epochs", "10"]
                        if mode == "sync" else [])
    out = run_twin(tmp_path, "diabetes_regression", *args)
    assert _value(out, "REAL holdout R^2") > 0.3, out
    assert ("sync: 2 rank processes" in out) == (mode == "sync")


def test_cifar10(tmp_path):
    out = run_twin(tmp_path, "cifar10", "--cpu", "--n", "512", "--epochs",
                   "1", "--batch", "32", "--workers", "2")
    assert "PS updates: " in out and "test accuracy:" in out, out


def test_higgs_workflow(tmp_path):
    out = run_twin(tmp_path, "higgs_workflow", "--cpu", "--n", "4096",
                   "--epochs", "1", "--workers", "2")
    assert "PS updates: " in out
    assert _value(out, "test accuracy:") > 0.6, out


LM = ("--cpu", "--seq", "32", "--rows", "256", "--epochs", "2")


def test_language_model_int8_bundle(tmp_path):
    bundle = str(tmp_path / "lm.dkt")
    out = run_twin(tmp_path, "language_model", *LM, "--int8",
                   "--save-bundle", bundle)
    assert "serving int8 weight-only (13 quantized matrices)" in out
    assert "decoding from the RELOADED copy" in out
    assert os.path.getsize(bundle) > 0
    assert len(_counting(out)) == 3, out


def test_language_model_speculative(tmp_path):
    out = run_twin(tmp_path, "language_model", *LM, "--speculative")
    line = next(line for line in out.splitlines()
                if line.startswith("speculative decode"))
    assert "(EXACT vs greedy)" in line, line
    rounds = int(line.rsplit(" in ", 1)[1].split(" verify")[0])
    assert 1 <= rounds <= 12, line
    rate = float(line.rsplit("(", 1)[1].split(" accepted")[0])
    assert 1.0 <= rate <= 5.0, line


def test_language_model_seq_parallel_two_ranks(tmp_path):
    out = run_twin(tmp_path, "language_model", *LM, "--seq-parallel", "2",
                   "--remat")
    assert "seq-parallel: 2 rank processes over gloo on the CPU" in out
    assert len(_counting(out)) == 3, out


@pytest.mark.parametrize("mode", ["ring", "ulysses"])
def test_long_context_two_ranks(tmp_path, mode):
    out = run_twin(tmp_path, "long_context", "--cpu", "--seq", "64",
                   "--rows", "128", "--epochs", "1", "--seq-parallel", "2",
                   "--sp-mode", mode)
    assert "devices: 2 x cpu; seq 64 -> 32 tokens/device" in out
    assert "over 2 devices" in out
    line = next(line for line in out.splitlines()
                if line.startswith("long-context"))
    assert f"{mode} attention on 2 blocks" in line
    assert _value(line, "test accuracy:") > 0.9, out


def test_optimizer_comparison(tmp_path):
    out_dir = tmp_path / "exp"
    out = run_twin(tmp_path, "optimizer_comparison", "--cpu", "--n", "1024",
                   "--rounds", "1", "--workers", "2", "--out", str(out_dir))
    assert "SyncDP: 2 rank processes over gloo on the CPU" in out
    payload = json.loads((out_dir / "optimizer_comparison.json").read_text())
    assert [r["optimizer"] for r in payload["results"]] == [
        "SingleTrainer", "SyncDP", "DOWNPOUR", "AEASGD", "EAMSGD", "ADAG",
        "DynSGD"]
    assert all(0.0 <= r["final_accuracy"] <= 1.0 for r in payload["results"])
    assert (out_dir / "optimizer_comparison.md").exists()
    assert sorted(os.listdir(out_dir)) == ["optimizer_comparison.json",
                                           "optimizer_comparison.md"]


def test_mnist_downpour(tmp_path):
    out = run_twin(tmp_path, "mnist", "downpour", "--cpu", "--n", "1024",
                   "--epochs", "1", "--workers", "2")
    assert "test accuracy:" in out


def test_mnist_sync_zero_two_ranks(tmp_path):
    out = run_twin(tmp_path, "mnist", "sync", "--cpu", "--n", "1024",
                   "--epochs", "1", "--workers", "2", "--zero")
    assert "sync: 2 rank processes over gloo on the CPU" in out
    assert "trained 7 steps" in out and "test accuracy:" in out


def test_twins_without_a_card_exit_nonzero(tmp_path):
    """No ``--cpu`` and no card (``CUDA_VISIBLE_DEVICES`` empty): every
    twin fails before it trains, with ``resolve_device``'s message, and
    never falls back to the CPU."""
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")

    def run(name):
        return _run(tmp_path, name, [], env=env)

    with ThreadPoolExecutor(4) as ex:
        outs = dict(zip(TWINS, ex.map(run, TWINS)))
    for name, out in outs.items():
        assert out.returncode != 0, (name, out.stdout[-1000:])
        assert "no CUDA device is available" in out.stderr, (
            name, out.stderr[-2000:])
        assert "trained" not in out.stdout, name
