"""The port's notebook twins (``examples/workflow_torch.ipynb``,
``examples/mnist_experiments_torch.ipynb``) run on the CPU.

Each notebook's code cells are read as JSON (``nbformat`` is not
installed) and run in order, as one script, in a subprocess whose working
directory is the notebook's folder, as a notebook server runs it. The
test sets the size, by exact substitutions in the cells' text (each must
apply once): the workflow on the CPU with 4096 rows and two epochs, the
experiments on 1024 rows, one round and two SyncDP ranks. Neither
notebook may import JAX or the JAX package, in its cells' text or at run
time.
"""

import json
import os
import re
import shutil
import signal
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = os.path.join(ROOT, "examples")
#: seconds a notebook may take at the test's size
TIMEOUT = 240
JAX_IMPORT = re.compile(r"^\s*(import|from)\s+(jax|distkeras_tpu)\b(?!_torch)",
                        re.M)
NO_JAX = (
    "\nbad = [m for m in sys.modules if m.split('.')[0] in "
    "('jax', 'distkeras_tpu')]\nassert not bad, bad\nprint('NO_JAX_OK')\n")


def _cells(name):
    with open(os.path.join(EXAMPLES, name)) as f:
        nb = json.load(f)
    assert nb["nbformat"] == 4
    return ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]


def _sized(cells, subs):
    """The cells' text with each (old, new) substitution applied once."""
    text = "\n\n".join(cells)
    for old, new in subs:
        assert text.count(old) == 1, old
        text = text.replace(old, new)
    return text


def _run(code, cwd, env=None):
    env = dict(os.environ if env is None else env)
    env.setdefault("OMP_NUM_THREADS", "2")
    env["MPLBACKEND"] = "Agg"
    proc = subprocess.Popen([sys.executable, "-c", code], cwd=cwd,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True, env=env, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the SyncDP ranks too
        proc.communicate()
        raise
    assert proc.returncode == 0, out[-2000:] + err[-3000:]
    assert "NO_JAX_OK" in out
    return out


@pytest.mark.parametrize("name", ["workflow_torch.ipynb",
                                  "mnist_experiments_torch.ipynb"])
def test_notebook_cells_import_no_jax(name):
    cells = _cells(name)
    assert cells
    for cell in cells:
        assert not JAX_IMPORT.search(cell), cell
        assert "distkeras_tpu." not in cell and "jax." not in cell, cell


def test_workflow_notebook_trains_and_evaluates():
    code = _sized(_cells("workflow_torch.ipynb"), [
        ('DEVICE = "cuda"', 'DEVICE = "cpu"'),
        ("synthetic_higgs(n=16384,", "synthetic_higgs(n=4096,"),
        ("num_epoch=4,", "num_epoch=2,"),
    ])
    out = _run(code + NO_JAX, EXAMPLES)
    acc = float(re.search(r"^test accuracy: ([0-9.]+)$", out, re.M).group(1))
    # 0.72 in three runs (threads mode is not deterministic); 0.5 is chance
    assert 0.6 < acc <= 1.0, out
    assert re.search(r"^wall time: [0-9.]+s, PS updates: [1-9]", out, re.M)
    assert re.search(r"^\d+ batch records$", out, re.M)


def test_experiments_notebook_plots_its_own_artifact(tmp_path):
    """Run where no artifact exists yet (a copy of the script in a fresh
    folder): the notebook makes ``experiments_torch/``, plots it there,
    tabulates every scheme, and writes nothing under ``experiments/``."""
    nb_dir = tmp_path / "examples"
    nb_dir.mkdir()
    shutil.copy(os.path.join(EXAMPLES, "optimizer_comparison_torch.py"),
                nb_dir)
    code = _sized(_cells("mnist_experiments_torch.ipynb"), [
        ('"--n", "6144", "--rounds", "4",',
         '"--n", "1024", "--rounds", "1", "--workers", "2",'),
    ])
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = _run(code + NO_JAX, str(nb_dir), env)
    art = nb_dir / "experiments_torch"
    assert sorted(os.listdir(art)) == ["optimizer_comparison.json",
                                       "optimizer_comparison.md",
                                       "optimizer_comparison.png"]
    assert (art / "optimizer_comparison.png").read_bytes()[:8] == (
        b"\x89PNG\r\n\x1a\n")
    assert sorted(os.listdir(nb_dir)) == ["experiments_torch",
                                          "optimizer_comparison_torch.py"]
    study = json.loads((art / "optimizer_comparison.json").read_text())
    assert study["platform"] == "cpu" and study["workers"] == 2
    for r in study["results"]:
        row = re.search(rf"^{r['optimizer']}\s+(\S+)\s+([0-9.]+)\s+", out,
                        re.M)
        assert row, (r["optimizer"], out)
        assert float(row.group(2)) == pytest.approx(r["final_accuracy"],
                                                     abs=1e-4)
    assert [r["optimizer"] for r in study["results"]] == [
        "SingleTrainer", "SyncDP", "DOWNPOUR", "AEASGD", "EAMSGD", "ADAG",
        "DynSGD"]
