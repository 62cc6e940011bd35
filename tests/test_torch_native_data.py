"""The PyTorch port's native data library (``distkeras_tpu_torch/native/
dkt_data.cpp`` through ``distkeras_tpu_torch.data.native``) vs the JAX
package's bridge on the CPU.

Both packages compile the same C++ with the same flags, so every parse
and gather is compared bit for bit (NaN where NaN). The port builds its
own library under ``distkeras_tpu_torch/kernels/_build`` and never writes
into the JAX package.
"""

import csv
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from distkeras_tpu.data import loaders as jloaders
from distkeras_tpu.data import native as jnative
from distkeras_tpu.data.dataset import Dataset as JDataset
from distkeras_tpu_torch.data import dataset as tdataset
from distkeras_tpu_torch.data import loaders, native
from distkeras_tpu_torch.data.dataset import Dataset

REPO = Path(__file__).resolve().parents[1]
DATA = REPO / "distkeras_tpu_torch" / "data"

needs_native = pytest.mark.skipif(
    not (native.available() and jnative.available()),
    reason="no C++ toolchain to build the native data libraries",
)


def _write_csv(path, n=200, d=9, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32) * 100
    y = rng.integers(0, 10, n)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["label"] + [f"f{i}" for i in range(d)])
        for i in range(n):
            w.writerow([int(y[i])] + [f"{v:.6g}" for v in x[i]])
    return path


def _parse(mod, path):
    """(array, header flag) or the exception type, for comparing both
    bridges' outcomes."""
    try:
        return mod.read_csv(str(path))
    except (ValueError, OSError) as e:
        return type(e)


@needs_native
def test_library_builds_outside_the_jax_package():
    """The port's library lives under its own ``kernels/_build`` and is
    named after the source's hash; the source is a copy of the JAX
    package's apart from its header comment."""
    path = native.library_path()
    assert path.is_file() and path.parent == native.BUILD_DIR
    assert path.parent == REPO / "distkeras_tpu_torch" / "kernels" / "_build"
    assert path.name.startswith("dkt_data-") and path.suffix == ".so"
    ours = native.SRC.read_text().split("#include <cctype>")[1]
    theirs = (REPO / "distkeras_tpu" / "native" / "dkt_data.cpp").read_text()
    assert ours == theirs.split("#include <cctype>")[1]


@needs_native
def test_concurrent_first_builds_publish_one_library(tmp_path):
    """Four processes racing to the first build into an empty directory
    (the ``-n 6`` test run's case): all load, one library is published
    and no temp file is left; none of them loads the JAX package."""
    code = (
        "import sys; from pathlib import Path\n"
        "from distkeras_tpu_torch.data import native\n"
        f"native.BUILD_DIR = Path({str(tmp_path)!r})\n"
        "assert native.available()\n"
        "assert not [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'distkeras_tpu')]\n"
        "print(native.library_path().name)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(4)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o.strip() for o, _ in outs}) == 1
    assert sorted(os.listdir(tmp_path)) == [outs[0][0].strip()]


@needs_native
@pytest.mark.parametrize("name", ["digits.csv", "breast_cancer.csv",
                                  "diabetes.csv"])
def test_repo_csvs_parse_like_jax(name, monkeypatch):
    """The three CSVs in the repository: the port's native parse is the
    JAX bridge's bit for bit, and its ``load_csv`` (native) equals the
    JAX package's and the csv-module path's."""
    path = str(DATA / name)
    a, ha = native.read_csv(path)
    b, hb = jnative.read_csv(path)
    assert ha == hb is True and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    assert native.csv_dims(path) == jnative.csv_dims(path)
    label_dtype = np.float32 if name == "diabetes.csv" else np.int64
    port = loaders.load_csv(path, label_dtype=label_dtype)
    ref = jloaders.load_csv(path, label_dtype=label_dtype)
    for col in ("features", "label"):
        np.testing.assert_array_equal(port[col], ref[col])
        assert port[col].dtype == ref[col].dtype
    monkeypatch.setenv("DKT_NO_NATIVE", "1")
    python = loaders.load_csv(path, label_dtype=label_dtype)
    for col in ("features", "label"):
        np.testing.assert_array_equal(python[col], port[col])


CASES = {
    "header": "label,f0,f1\n1,2.5,-3\n0,4e-2,1e+2\n",
    "headerless": "1.0,2.0\n3.0,4e-2\n\n5.0,-6.5\n",
    "nan_inf_first_row": "nan,inf,-inf\n1.0,2.0,3.0\n",
    "nan_inf_body": "a,b\nnan,-inf\ninf,-0.0\n",
    "blank_lines": "a,b\n\n1,2\n   \n3,4\n\n",
    "crlf": "a,b\r\n1,2\r\n3,4\r\n",
    "quoted": 'label,f0\n"1","2.5"\n0,3.5\n',
    "exponents": "a,b,c\n-1.5e3,2E-4,+7\n0,-0.0,1e+2\n",
    "malformed": "a,b\n1.0,oops\n",
    "trailing_empty": "a,b,c\n1,2,\n4,5,6\n",
    "too_few": "a,b,c\n1,2\n",
    "too_many": "a,b,c\n1,2,3,4\n",
    "empty_file": "",
}


@needs_native
@pytest.mark.parametrize("case", sorted(CASES))
def test_edge_cases_parse_like_jax(case, tmp_path):
    """nan/inf, header sniffing, blank lines, CRLF, quotes, exponents and
    malformed, empty or ragged rows: the same array (NaN where NaN) and
    header flag, or the same exception, from both bridges."""
    path = tmp_path / f"{case}.csv"
    path.write_text(CASES[case])
    a, b = _parse(native, path), _parse(jnative, path)
    if isinstance(b, type):
        assert a is b
        return
    assert a[1] == b[1]
    assert a[0].shape == b[0].shape and a[0].dtype == b[0].dtype
    np.testing.assert_array_equal(a[0], b[0])
    if case in ("headerless", "nan_inf_first_row"):
        assert not a[1] and native.csv_dims(str(path)) == jnative.csv_dims(
            str(path))


@needs_native
def test_gather_and_dataset_shuffle_match_jax(monkeypatch):
    """``gather_rows`` equals the JAX bridge's and numpy's indexing; a
    port ``Dataset``'s shuffle and partition take it for contiguous f32
    columns only (numpy for the rest, for a non-contiguous view and for
    negative indices) and equal the JAX ``Dataset``'s."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((97, 3, 4)).astype(np.float32)
    idx = rng.permutation(97)[:60]
    np.testing.assert_array_equal(native.gather_rows(x, idx),
                                  jnative.gather_rows(x, idx))
    np.testing.assert_array_equal(native.gather_rows(x, idx), x[idx])
    calls = []
    real = native.gather_rows
    monkeypatch.setattr(native, "gather_rows",
                        lambda src, i: calls.append(src.dtype) or real(src, i))
    cols = {"f": x, "i": rng.integers(0, 9, 97), "t": x.transpose(0, 2, 1)}
    port, ref = Dataset(cols).shuffle(4), JDataset(cols).shuffle(4)
    assert calls == [np.float32]  # f only: "i" is int, "t" a strided view
    for k in cols:
        np.testing.assert_array_equal(port[k], ref[k])
    for p, r in zip(Dataset(cols).partition(3), JDataset(cols).partition(3)):
        np.testing.assert_array_equal(p["f"], r["f"])
    neg = np.array([-1, 0, 5])
    np.testing.assert_array_equal(tdataset._take_rows(x, neg), x[neg])
    assert len(calls) == 4


def test_entry_points_raise_cleanly_when_disabled(tmp_path, monkeypatch):
    """``DKT_NO_NATIVE=1``: unavailable, the entry points raise the JAX
    bridge's RuntimeError, and ``load_csv`` takes the csv-module path."""
    monkeypatch.setenv("DKT_NO_NATIVE", "1")
    assert not native.available()
    with pytest.raises(RuntimeError, match="unavailable"):
        native.read_csv(str(tmp_path / "x.csv"))
    with pytest.raises(RuntimeError, match="unavailable"):
        native.gather_rows(np.zeros((2, 2), np.float32), np.array([0]))
    path = _write_csv(str(tmp_path / "a.csv"))
    port, ref = loaders.load_csv(path), jloaders.load_csv(path)
    np.testing.assert_array_equal(port["features"], ref["features"])
    np.testing.assert_array_equal(port["label"], ref["label"])
