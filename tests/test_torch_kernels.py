"""The port's CUDA kernels: their wrappers' contract on any machine, and
the kernels themselves against their plain versions on a card (marker
``gpu``; skipped without one).

This file imports nothing of JAX, so on the GPU machine it runs without
the repository's JAX-side conftest:

    python -m pytest --noconftest tests/test_torch_kernels.py
"""

import shutil
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from distkeras_tpu_torch import kernels
from distkeras_tpu_torch.kernels import build
from distkeras_tpu_torch.ops import flash_attention as tfa
from distkeras_tpu_torch.ops import fused_layernorm as tln
from distkeras_tpu_torch.ops import pallas_kernels as tpk

ZERO_COUNTS = dict.fromkeys(
    ["layernorm_fwd", "layernorm_bwd", "flash_fwd", "flash_bwd_dq",
     "flash_bwd_dkv", "adam_fused", "sgd_fused", "sgd_momentum_fused"], 0)

torch.set_num_threads(2)


def _ln_inputs(shape, seed=0):
    rng = np.random.default_rng(seed)
    d = shape[-1]
    x = (rng.standard_normal(shape) * 2 + 0.5).astype(np.float32)
    g = (1 + 0.1 * rng.standard_normal(d)).astype(np.float32)
    b = (0.1 * rng.standard_normal(d)).astype(np.float32)
    return x, g, b


def _qkv(b=2, t=64, h=2, d=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, t, h, d)).astype(np.float32)
            for _ in range(3)]


def test_cpu_tensors_take_the_plain_path_and_count_nothing():
    """Forward, backward and the optimizer step on CPU tensors run the
    plain versions and launch nothing."""
    kernels.reset_launch_counts()
    x, g, b = (torch.from_numpy(a).requires_grad_()
               for a in _ln_inputs((16, 128)))
    tln.fused_layer_norm(x, g, b).sum().backward()
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv())
    tfa.flash_attention(q, k, v, causal=True).sum().backward()
    opt = tpk.FusedAdam(1e-3)
    params = [x.detach(), q.detach()]
    opt.fused_apply(params, [x.grad, q.grad], opt.init(params))
    for mu in (0.0, 0.9):
        sgd = tpk.FusedSGD(1e-3, momentum=mu)
        sgd.fused_apply(params, [x.grad, q.grad], sgd.init(params))
    assert kernels.launch_counts() == ZERO_COUNTS
    assert tfa.effective_path(64, 64, "cpu") == ("plain", 64, 64)
    assert tfa.effective_path(200, 64, "cuda") == ("flash", 64, 64)
    assert tfa.effective_bwd_blocks(200, 64, "cuda") == (64, 64)
    with pytest.raises(ValueError, match="head_dim"):
        tfa.effective_path(64, 256, "cuda")


def test_launch_counter_loses_no_update_under_threads():
    """The engine's scheduler thread and the predict batcher's thread both
    launch kernels; their counts must add up exactly."""
    kernels.reset_launch_counts()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [
            threading.Thread(target=lambda: [
                kernels.count_launch("layernorm_fwd") for _ in range(2000)
            ])
            for _ in range(16)
        ]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert kernels.launch_counts() == {**ZERO_COUNTS, "layernorm_fwd": 32000}
    kernels.reset_launch_counts()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers never fall back: a CPU tensor is a caller error
    there (the public functions route CPU tensors to the plain path)."""
    x, g, b = (torch.from_numpy(a) for a in _ln_inputs((8, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm_fwd(x, g, b, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm_bwd(x, g, x.clone(), 1e-5)
    q, k, v = (torch.from_numpy(a) for a in _qkv())
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(q, k, v, True)
    lse = torch.zeros(2, 2, 64, 1)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_bwd(q, k, v, q, lse, q, True)
    step = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        tpk.adam_fused([x], [x], [x], [x], step, 1e-3, 0.9, 0.999, 1e-8,
                       tpk._TableCache())
    with pytest.raises(ValueError, match="CUDA"):
        tpk.sgd_fused([x], [x], 0.01, tpk._TableCache())
    with pytest.raises(ValueError, match="CUDA"):
        tpk.sgd_momentum_fused([x], [x], [x], 0.01, 0.9, True,
                               tpk._TableCache())


def test_kernel_sources_target_hopper():
    """Each kernel builds from a CUDA source in this checkout, for sm_90a,
    through a plain C launcher the wrapper binds; the two flash backward
    kernels share one source (one library, one nvcc)."""
    assert build.ARCH_FLAGS == ["-gencode", "arch=compute_90a,code=sm_90a"]
    for name, (src, symbol, argtypes) in build.KERNELS.items():
        text = (build.CSRC / src).read_text()
        assert f'extern "C" int {symbol}(' in text
        assert text.count("extern \"C\"") == len(
            [n for n, kv in build.KERNELS.items() if kv[0] == src])
        assert len(argtypes) == text.split(f"{symbol}(")[1].split(")")[0].count(",") + 1
        assert "torch" not in text  # no PyTorch headers: seconds to build
        assert build.CSRC == Path(tfa.__file__).parents[1] / "kernels" / "csrc"
    assert set(build.KERNELS) == set(kernels.LAUNCHES)
    sources = {name: kv[0] for name, kv in build.KERNELS.items()}
    assert sources["adam_fused"] == "adam_fused.cu"
    assert sources["flash_bwd_dq"] == sources["flash_bwd_dkv"] == "flash_bwd.cu"
    assert sources["layernorm_bwd"] == "layernorm_bwd.cu"
    assert sources["sgd_fused"] == sources["sgd_momentum_fused"] == "sgd_fused.cu"
    assert build._library_path("flash_bwd_dq") == build._library_path("flash_bwd_dkv")
    assert "--use_fast_math" not in " ".join(build.ARCH_FLAGS)


def test_flash_sources_share_one_helper_header():
    """The fragment, mma, ldmatrix, cp.async and split helpers live once,
    in flash_common.cuh, which both flash sources include."""
    header = (build.CSRC / "flash_common.cuh").read_text()
    defs = ['asm("mma.sync', '"ldmatrix.sync', '"cp.async.cg',
            "uint32_t to_tf32(float", "struct Split", "void tile_pb(",
            "void tile_abt("]
    for src in ("flash_fwd.cu", "flash_bwd.cu"):
        text = (build.CSRC / src).read_text()
        assert '#include "flash_common.cuh"' in text
        assert build._source_files(build.CSRC / src) == [
            build.CSRC / src, build.CSRC / "flash_common.cuh"]
        for needle in defs:
            assert needle in header and needle not in text, (src, needle)
    assert "sP" not in (build.CSRC / "flash_fwd.cu").read_text()


def test_library_path_hashes_included_headers(tmp_path, monkeypatch):
    """A library is named after its source and every header it includes
    with quotes, through other headers too: editing flash_common.cuh
    renames (so rebuilds) both flash libraries and nothing else."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    monkeypatch.setattr(build, "CSRC", tmp_path)
    before = {n: build._library_path(n) for n in build.KERNELS}
    header = tmp_path / "flash_common.cuh"
    header.write_bytes(header.read_bytes() + b"\n// edited\n")
    after = {n: build._library_path(n) for n in build.KERNELS}
    assert {n for n in before if before[n] != after[n]} == {
        "flash_fwd", "flash_bwd_dq", "flash_bwd_dkv"}
    assert after["flash_bwd_dq"] == after["flash_bwd_dkv"]
    (tmp_path / "nested.cuh").write_text("// one\n")
    header.write_text('#include "nested.cuh"\n' + header.read_text())
    mid = build._library_path("flash_fwd")
    (tmp_path / "nested.cuh").write_text("// two\n")
    assert build._library_path("flash_fwd") != mid
    assert build._library_path("layernorm_bwd") == before["layernorm_bwd"]


def test_layernorm_bwd_block_count():
    """bwd_blocks alone fixes the backward's blocks (so the fold's order):
    8 warps of 2 rows each up to D = 1024, one block per row above."""
    assert tln.bwd_blocks(4096, 512) == 256
    assert tln.bwd_blocks(8, 512) == 1
    assert tln.bwd_blocks(1000, 512) == 63
    assert tln.bwd_blocks(37, 510) == 3
    assert tln.bwd_blocks(3, 2048) == 3
    assert tln.bwd_blocks(10 ** 7, 64) == 65535
    assert tln.bwd_blocks(5000, 2048) == 1024


def test_layernorm_fwd_paths_follow_the_launcher_rule():
    """``fwd_path`` mirrors ``launch`` in layernorm_fwd.cu: 16-byte chunks
    where a row is whole chunks and every pointer is 16-byte aligned, one
    element per chunk otherwise, the block kernel above D = 1024; the C
    signature (so the ctypes argtypes) is the one it always had."""
    P, I, F, L = build._P, build._I, build._F, build._L
    assert build.KERNELS["layernorm_fwd"][2] == [P, P, P, P, L, I, F, I, P]
    g = torch.ones(512)
    for shape, dtype, offset, path in LN_FWD_CASES:
        d = shape[1]
        base = torch.empty(4 * d + offset, dtype=dtype)
        x = base[offset:offset + 2 * d].view(2, d)
        gd = g[:1].expand(d).contiguous() if d != 512 else g
        y = torch.empty_like(x)
        if x.data_ptr() % 16 == 0 or offset:
            assert tln.fwd_path(x, gd, gd, y) == path, (shape, dtype, offset)
    text = (build.CSRC / "layernorm_fwd.cu").read_text()
    assert "d > 1024" in text and "% 16 == 0" in text and "& 15) == 0" in text


def test_build_without_nvcc_raises(monkeypatch):
    if shutil.which("nvcc") or Path("/usr/local/cuda/bin/nvcc").exists():
        pytest.skip("a CUDA toolkit is installed here")
    monkeypatch.delenv("CUDA_HOME", raising=False)
    with pytest.raises(RuntimeError, match="nvcc"):
        build.build(["layernorm_fwd"])


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (run on the GPU machine)")
    return torch.device("cuda")


#: (shape, dtype, storage offset in elements, path the launcher takes)
LN_FWD_CASES = [
    ((8, 512), torch.float32, 0, "vector"),
    ((4096, 512), torch.float32, 0, "vector"),
    ((4096, 512), torch.bfloat16, 0, "vector"),
    ((8, 512), torch.float16, 0, "vector"),
    ((3, 96), torch.float32, 0, "vector"),
    ((5, 96), torch.bfloat16, 0, "vector"),
    ((37, 510), torch.float32, 0, "scalar"),
    ((37, 510), torch.bfloat16, 0, "scalar"),
    ((16, 512), torch.float32, 1, "scalar"),
    ((16, 512), torch.float16, 3, "scalar"),
    ((3, 1000), torch.float32, 0, "vector"),
    ((2, 2048), torch.float32, 0, "block"),
    ((3, 2048), torch.bfloat16, 0, "block"),
    ((3, 2050), torch.float16, 0, "block"),
    ((2, 60000), torch.float32, 0, "block"),
]


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype,offset,path", LN_FWD_CASES)
def test_layernorm_kernel_on_card(cuda_device, shape, dtype, offset, path):
    """The forward kernel against the plain version on its three paths:
    16-byte chunks (f32 float4, 8 halves in bf16/f16), one-element chunks
    where a row is not a whole number of 16-byte chunks (D = 510) or x is
    a view with a storage offset, and the block kernel above D = 1024
    (its row in shared memory; D = 60000 is read again from L2). f32 to
    1e-5 absolute; bf16/f16 within one rounding of the output (1e-2
    absolute + 1e-2 relative). A second launch gives the same bits, and so
    does the hook under ``no_grad`` (no autograd function; a (1, rows, D)
    input launched without a reshape)."""
    x, g, b = (torch.from_numpy(a).to(cuda_device) for a in _ln_inputs(shape))
    n = x.numel()
    base = torch.empty(n + offset, dtype=dtype, device=cuda_device)
    base[offset:] = x.reshape(-1).to(dtype)
    x = base[offset:].view(shape)
    assert x.storage_offset() == offset and x.is_contiguous()
    y = torch.empty_like(x)
    assert tln.fwd_path(x, g, b, y) == path
    kernels.reset_launch_counts()
    got = tln.layernorm_fwd(x, g, b, 1e-5)
    again = tln.layernorm_fwd(x, g, b, 1e-5)
    with torch.no_grad():
        hooked = tln.fused_layer_norm(x, g, b)
        hooked3 = tln.fused_layer_norm(x.unsqueeze(0), g, b)
    assert kernels.launch_counts()["layernorm_fwd"] == 4
    ref = tln._reference_layer_norm(x, g, b, 1e-5)
    assert got.dtype == dtype
    if dtype == torch.float32:
        torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)
    else:
        torch.testing.assert_close(got.float(), ref.float(), atol=1e-2,
                                   rtol=1e-2)
    assert torch.equal(got, again) and torch.equal(got, hooked)
    assert hooked3.shape == (1, *shape) and torch.equal(hooked3[0], got)


#: (T, causal, head dim, dtype) of the flash kernels' card tests: every
#: head-dim instantiation (32/64/128, and 36/40 zero-padded; 36 halves is
#: the element-load path), tails of one row (T = 1, 65), f32/bf16/f16
FLASH_CASES = [
    (512, True, 64, torch.float32), (512, False, 64, torch.float32),
    (200, True, 64, torch.float32), (512, True, 64, torch.bfloat16),
    (200, False, 64, torch.float16), (512, True, 32, torch.float32),
    (512, True, 128, torch.float32), (200, False, 128, torch.bfloat16),
    (1, True, 64, torch.float32), (65, True, 64, torch.float32),
    (65, False, 32, torch.bfloat16), (100, True, 36, torch.float16),
    (70, False, 40, torch.float32)]


def _fwd_16bit_tolerance(q, k, v, causal, ref_o):
    """Elementwise tolerance of O for 16-bit inputs. The kernel rounds P to
    the input type before P V: at most u = 2^-8 of each term, so u * sum
    p |v| over the keys (p normalized). Both sides round O to the input
    type: one ulp, 2u * |ref|. The first term is doubled to cover the f32
    sums' order."""
    u = 2.0 ** -8  # unit roundoff of bf16 (f16's is smaller)
    p = torch.softmax(tfa._scores(q, k, causal), dim=-1)
    pv = torch.einsum("bhqk,bkhd->bqhd", p, v.float().abs())
    return u * (2 * pv + 2 * ref_o.float().abs()) + 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("t,causal,d,dtype", FLASH_CASES)
def test_flash_kernel_on_card(cuda_device, t, causal, d, dtype):
    """O and lse against the plain forward: f32 O to 2e-5 and lse to 1e-5
    absolute (3xTF32 keeps f32-level error); 16-bit O within the rounding
    bound of ``_fwd_16bit_tolerance``, lse to 1e-5; a second identical
    call gives the same bits."""
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, t, 8, d))
                                .astype(np.float32)).to(cuda_device, dtype)
               for _ in range(3))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    again = tfa.flash_fwd(q, k, v, causal)
    ro, rlse = tfa._reference_flash_fwd(q, k, v, causal)
    assert o.dtype == dtype and lse.dtype == torch.float32
    if dtype == torch.float32:
        torch.testing.assert_close(o, ro, atol=2e-5, rtol=0)
    else:
        tol = _fwd_16bit_tolerance(q, k, v, causal, ro)
        err = (o.float() - ro.float()).abs()
        assert bool((err <= tol).all()), float((err / tol).max())
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=0)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


def _infinite_q_rows(device, causal, rows, seed=3, grad=False):
    """q, k, v (and dO with ``grad``) of shape (2, 130, 4, 64) f32 on
    ``device``: every key's first component negative and each (b, t, h)
    of ``rows`` a query (+inf, 0, ..., 0), whose every score is then
    inf * (negative) + 0 = -inf: the row attends nothing."""
    rng = np.random.default_rng(seed)
    ts = [torch.from_numpy(rng.standard_normal((2, 130, 4, 64))
                           .astype(np.float32)).to(device)
          for _ in range(4 if grad else 3)]
    ts[1][..., 0] = -ts[1][..., 0].abs() - 0.5
    for b, t, h in rows:
        ts[0][b, t, h] = 0.0
        ts[0][b, t, h, 0] = float("inf")
    return ts


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_flash_fwd_row_that_attends_nothing_on_card(cuda_device, dtype,
                                                    causal):
    """A query row whose every score is -inf (q = (+inf, 0, ..., 0) against
    keys whose first component is negative) keeps m = -inf: its O is 0 (l
    = 0 divides by 1) and its lse -inf, the JAX kernel's guards, and every
    other row matches the plain version. 16-bit products are exact, so the
    score is -inf itself; in f32 the blocks that meet the infinity run
    their loop again with the guarded 3xTF32 split, whose product is the
    exact -inf too."""
    empty = [(0, 5, 1), (1, 129, 3)]  # (b, t, h)
    q, k, v = (t.to(dtype) for t in _infinite_q_rows(cuda_device, causal,
                                                      empty))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    again = tfa.flash_fwd(q, k, v, causal)
    ro, rlse = tfa._reference_flash_fwd(q, k, v, causal)
    keep = torch.ones(o.shape[:3], dtype=torch.bool, device=cuda_device)
    for b, t, h in empty:
        assert bool((o[b, t, h] == 0).all())
        assert float(lse[b, h, t, 0]) == float("-inf")
        keep[b, t, h] = False
    assert torch.isfinite(o).all()
    err = (o.float() - ro.float()).abs()
    if dtype == torch.float32:
        assert float(err[keep].max()) <= 2e-5
    else:
        tol = _fwd_16bit_tolerance(q, k, v, causal, ro)
        assert bool((err <= tol)[keep].all())
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=0)
    assert torch.equal(o, again[0]) and torch.equal(lse, again[1])


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_infinite_q_element_on_card(cuda_device, causal):
    """The f32 backward on the forward's output for rows with an infinite
    q element, held to what JAX's kernels give: the row's dQ is 0 (its P
    is 0), dV is finite and equal to the plain version's, and dK is NaN
    exactly where the plain version's is (dS^T Q multiplies that row's
    dS = 0 by the infinity, 0 * inf). The rows lie in the last query tile,
    which every key tile visits under causal masking too, so the kernel's
    NaN pattern is the plain version's over all keys."""
    rows = [(0, 128, 1), (1, 129, 3)]
    q, k, v, do = _infinite_q_rows(cuda_device, causal, rows, grad=True)
    o, lse = tfa.flash_fwd(q, k, v, causal)
    dq, dk, dv = tfa.flash_bwd(q, k, v, o, lse, do, causal)
    rdq, rdk, rdv = tfa._reference_flash_bwd(q, k, v, o, lse, do, causal)
    for b, t, h in rows:
        assert bool((dq[b, t, h] == 0).all())
        assert bool(torch.isnan(rdk[b, :, h, 0]).all())
    assert torch.isfinite(dq).all() and torch.isfinite(dv).all()
    assert torch.equal(torch.isnan(dk), torch.isnan(rdk))
    assert not torch.isinf(dk).any()
    for a, r in ((dq, rdq), (dv, rdv)):
        torch.testing.assert_close(
            a, r, atol=1e-4 * max(1.0, float(r.abs().max())), rtol=0)
    fin = torch.isfinite(rdk)
    tol = 1e-4 * max(1.0, float(rdk[fin].abs().max()))
    assert float((dk - rdk)[fin].abs().max()) <= tol


def _bwd_16bit_tolerances(q, k, v, do, lse, delta, causal, ref):
    """Elementwise tolerances of (dQ, dK, dV) for 16-bit inputs. The kernel
    rounds P and dS to the input type before the second product: at most
    u = 2^-8 of each term, so u * sum |x||y| over the reduced index. Both
    sides round the output to the input type: one ulp, 2u * |ref|. The
    first term is doubled to cover the f32 sums' order."""
    u = 2.0 ** -8  # unit roundoff of bf16 (f16's is smaller)
    p, ds = tfa._reference_p_ds(q, k, v, do, lse, delta, causal)
    sums = (torch.einsum("bhqk,bkhd->bqhd", ds.abs(), k.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", ds.abs(), q.float().abs()),
            torch.einsum("bhqk,bqhd->bkhd", p, do.float().abs()))
    return [u * (2 * s + 2 * r.float().abs()) + 1e-6 for s, r in zip(sums, ref)]


@pytest.mark.gpu
@pytest.mark.parametrize("t,causal,d,dtype", FLASH_CASES)
def test_flash_bwd_kernels_on_card(cuda_device, t, causal, d, dtype):
    """dQ, dK, dV against the plain backward at every head-dim
    instantiation (32/64/128, and 36/40 zero-padded; 36 halves is the
    element-load path), tails of one row (T = 1, 65), f32/bf16/f16; a
    second identical call gives the same bits (no atomics)."""
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, t, 8, d))
                                    .astype(np.float32)).to(cuda_device, dtype)
                   for _ in range(4))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    got = tfa.flash_bwd(q, k, v, o, lse, do, causal)
    again = tfa.flash_bwd(q, k, v, o, lse, do, causal)
    ref = tfa._reference_flash_bwd(q, k, v, o, lse, do, causal)
    if dtype == torch.float32:
        tols = [1e-4 * max(1.0, float(r.abs().max())) for r in ref]
    else:
        _, delta = tfa._reference_flash_bwd_dq(q, k, v, o, lse, do, causal)
        tols = _bwd_16bit_tolerances(q, k, v, do, lse, delta, causal, ref)
    for a, r, tol in zip(got, ref, tols):
        assert a.dtype == dtype
        assert bool(((a.float() - r.float()).abs() <= tol).all()), (
            float((a.float() - r.float()).abs().max()))
    for a, b in zip(got, again):
        assert torch.equal(a, b)


@pytest.mark.gpu
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_row_that_attends_nothing_on_card(cuda_device, causal):
    """A row whose lse is -inf (it attends nothing) shifts by 0, the JAX
    kernels' guard, in both backward kernels as in the plain version."""
    rng = np.random.default_rng(2)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, 130, 4, 64))
                                    .astype(np.float32)).to(cuda_device)
                   for _ in range(4))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    lse[0, 1, 5] = float("-inf")
    lse[1, 3, 129] = float("-inf")
    got = tfa.flash_bwd(q, k, v, o, lse, do, causal)
    ref = tfa._reference_flash_bwd(q, k, v, o, lse, do, causal)
    for a, r in zip(got, ref):
        assert torch.isfinite(a).all()
        tol = 1e-4 * max(1.0, float(r.abs().max()))
        torch.testing.assert_close(a, r, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((8, 512), torch.float32),
                                         ((4096, 512), torch.float32),
                                         ((4096, 512), torch.bfloat16),
                                         ((5, 96), torch.float32),
                                         ((3, 2048), torch.float32),
                                         ((37, 510), torch.float32),
                                         ((4096, 512), torch.float16),
                                         ((1000, 512), torch.float32)])
def test_layernorm_bwd_kernel_on_card(cuda_device, shape, dtype):
    """dx, dgamma, dbeta against the plain backward: the 16-byte vector
    path (D = 512 in f32 and in 16-bit), the element path (D = 510, 96),
    the block kernel (D = 2048), the fold over one group (<= 16 blocks),
    two levels (1000 rows: 63 blocks, a short last group) and 16 full
    groups (4096 rows); a second call gives the same bits."""
    x, g, _ = (torch.from_numpy(a).to(cuda_device) for a in _ln_inputs(shape))
    dy = torch.from_numpy(_ln_inputs(shape, seed=2)[0]).to(cuda_device)
    x, dy = x.to(dtype), dy.to(dtype)
    dx, dg, db = tln.layernorm_bwd(x, g, dy, 1e-5)
    rdx, rdg, rdb = tln._reference_layer_norm_bwd(x, g, dy, 1e-5)
    atol = 1e-5 if dtype == torch.float32 else 1e-2
    torch.testing.assert_close(dx.float(), rdx.float(), atol=atol, rtol=1e-2 * (dtype != torch.float32))
    torch.testing.assert_close(dg, rdg, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(db, rdb, rtol=1e-4, atol=1e-4)
    again = tln.layernorm_bwd(x, g, dy, 1e-5)
    assert torch.equal(again[1], dg) and torch.equal(again[2], db)


@pytest.mark.gpu
def test_adam_kernel_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = [(513, 7), (1000,), (4096, 3), (12,)]
    params = [torch.randn(s, device=cuda_device, generator=gen) for s in shapes]
    grads = [torch.randn(s, device=cuda_device, generator=gen) for s in shapes]
    kp = [p.clone() for p in params]
    opt = tpk.FusedAdam(1e-3)
    ms, vs, step = opt.init(kp)
    rp = [p.clone() for p in params]
    rm, rv = [m.clone() for m in ms], [v.clone() for v in vs]
    rstep = step.clone()
    for _ in range(3):
        opt.fused_apply(kp, grads, (ms, vs, step))
        tpk.adam_step_plain(rp, grads, rm, rv, rstep, 1e-3, 0.9, 0.999, 1e-8)
    assert step.tolist() == [3, 0] and rstep.tolist() == [3, 0]
    for a, b in zip(kp + ms + vs, rp + rm + rv):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=0)


def _views(shapes, dtype, device, offset, gen):
    """Seeded leaves of ``shapes``: with ``offset`` each is a contiguous
    view at a 1-element offset into a buffer of its own, so its pointer
    is off the 16-byte grid."""
    out = []
    for s in shapes:
        n = int(np.prod(s))
        base = torch.randn(n + offset, device=device, generator=gen)
        out.append(base.to(dtype)[offset:].view(s))
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("mu,nesterov,dtype,offset", [
    (0.0, False, torch.float32, 0), (0.9, False, torch.float32, 0),
    (0.9, True, torch.float32, 0), (0.0, False, torch.bfloat16, 0),
    (0.9, True, torch.bfloat16, 0), (0.0, False, torch.float16, 0),
    (0.9, True, torch.float16, 0), (0.0, False, torch.bfloat16, 1),
    (0.9, True, torch.float32, 1), (0.9, False, torch.float16, 1)])
def test_sgd_kernels_on_card(cuda_device, mu, nesterov, dtype, offset):
    """B1/B2 vs their plain versions, 3 steps over leaves that are small,
    ragged and larger than a chunk: bit-equal (same operation order, each
    step rounded, the same rounding to bf16/f16). With ``offset`` every p,
    g and m is a contiguous view at a 1-element offset (the scalar path)."""
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    shapes = [(513, 7), (1000,), (4096, 3), (12,), (3,), (8192 * 2 + 9,)]
    params = _views(shapes, dtype, cuda_device, offset, gen)
    grads = _views(shapes, dtype, cuda_device, offset, gen)
    opt = tpk.FusedSGD(0.05, momentum=mu, nesterov=nesterov)
    kp = [p.clone() for p in params]
    km = []
    if mu:
        km = _views(shapes, torch.float32, cuda_device, offset, gen)
        if offset:
            assert all(m.data_ptr() % 16 for m in km)
    rp = [p.clone() for p in params]
    rm = [m.clone() for m in km]
    if offset:
        kp = [torch.empty(p.numel() + 1, dtype=dtype, device=cuda_device)
              [1:].view(p.shape).copy_(p) for p in params]
        assert all(t.data_ptr() % 16 for t in kp + grads)
    kernels.reset_launch_counts()
    for _ in range(3):
        opt.fused_apply(kp, grads, km)
        if mu:
            tpk.sgd_momentum_step_plain(rp, grads, rm, 0.05, mu, nesterov)
        else:
            tpk.sgd_step_plain(rp, grads, 0.05)
    name = "sgd_momentum_fused" if mu else "sgd_fused"
    assert kernels.launch_counts()[name] == 3
    assert opt._tables.builds == 1
    for a, b in zip(kp + list(km), rp + rm, strict=True):
        assert torch.equal(a, b)


def test_sgd_launcher_argtypes_match_the_source():
    """The ctypes argument lists of the two SGD launchers follow their C
    signatures argument by argument: pointers, then ints for the chunk
    walk (the count and the per-dtype chunk), float lr (and mu, int
    nesterov), the dtype code and the stream."""
    import re

    P, I, F = build._P, build._I, build._F
    assert build.KERNELS["sgd_fused"][2] == [P, P, P, I, I, F, I, P]
    assert build.KERNELS["sgd_momentum_fused"][2] == [
        P, P, P, I, I, F, F, I, I, P]
    text = (build.CSRC / "sgd_fused.cu").read_text()
    c_types = {"const void*": P, "void*": P, "int": I, "float": F}
    for name in ("sgd_fused", "sgd_momentum_fused"):
        _, symbol, argtypes = build.KERNELS[name]
        sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
        args = [re.sub(r"\s*\w+$", "", a.strip())
                for a in sig.group(1).split(",")]
        assert [c_types[a] for a in args] == argtypes, name
    assert "__fsub_rn(p, __fmul_rn(lr, g))" in text
    assert "__float2bfloat16_rn" in text and "__floats2bfloat162_rn" in text
    assert "_sgd_kernel" in text and "_sgd_momentum_kernel" in text


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16])
def test_sgd_chunk_tables_cover_every_element_once(dtype):
    """B1/B2's chunk table for each dtype: chunks of 16 KiB of p (4096 f32,
    8192 bf16/f16 elements), each leaf cut into consecutive pieces that
    cover its elements exactly once, none longer than the chunk, and the
    leaf table's pointers and lengths the buffers' own."""
    chunk = tpk.sgd_chunk(dtype)
    assert chunk * torch.empty((), dtype=dtype).element_size() \
        == tpk.SGD_CHUNK_BYTES == 16384
    sizes = [1, 3, 7, chunk - 1, chunk, chunk + 1, 3 * chunk, 2 * chunk + 9]
    params = [torch.zeros(n, dtype=dtype) for n in sizes]
    moms = [torch.zeros(n) for n in sizes]
    cache = tpk._TableCache()
    table, _ = cache.get((params, moms), params, chunk)
    assert table.chunk == chunk
    leaves = table.leaves.numpy()
    assert leaves.shape == (len(sizes), 3)
    assert list(leaves[:, 0]) == [p.data_ptr() for p in params]
    assert list(leaves[:, 1]) == [m.data_ptr() for m in moms]
    assert list(leaves[:, 2]) == sizes
    chunks = table.chunks.numpy()
    assert table.n_chunks == len(chunks) == sum(-(-n // chunk) for n in sizes)
    for li, n in enumerate(sizes):
        seen = np.zeros(n, np.int64)
        for leaf, start in chunks:
            if leaf == li:
                end = min(start + chunk, n)
                assert 0 < end - start <= chunk
                seen[start:end] += 1
        assert (seen == 1).all(), (dtype, n)
    # one table per (chunk, buffers): B3's 4096-element table of the same
    # buffers is another entry
    assert cache.get((params, moms), params, chunk)[0] is table
    assert cache.get((params, moms), params)[0].chunk == tpk.CHUNK
    assert cache.builds == 1 + (chunk != tpk.CHUNK)


@pytest.mark.gpu
@pytest.mark.parametrize("model,opt", [
    ("resnet18", "adam"), ("resnet18", "sgd"),
    ("cifar10_cnn", "adam"), ("cifar10_cnn", "sgd")])
def test_fused_optimizers_on_conv_gradients_on_card(cuda_device, model, opt):
    """B3/B1 over a CNN's parameter set whose gradients came through
    ``Conv2D`` in bf16 (``resnet18`` at (64, 64, 3), 62 leaves;
    ``cifar10_cnn``, 16 leaves): every gradient arrives contiguous (the
    HWIO kernels' too, which the convolution reads through a permuted
    view), the kernel launches once and its result is bit-equal to the
    plain version's, over two steps."""
    from distkeras_tpu_torch.models import zoo
    from distkeras_tpu_torch.ops.losses import get_loss

    kw = {"resnet18": dict(num_classes=10, input_shape=(64, 64, 3)),
          "cifar10_cnn": {}}[model]
    net = getattr(zoo, model)(device=cuda_device, **kw).train()
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    x = torch.rand((8, *net.input_shape), device=cuda_device, generator=gen)
    y = torch.eye(10, device=cuda_device)[torch.arange(8) % 10]
    params = [p.detach().clone() for p in net.parameters()]
    kernels.reset_launch_counts()
    steps = []
    for _ in range(2):
        loss = get_loss("categorical_crossentropy")(
            net(x.to(torch.bfloat16), rng=0).float(), y)
        grads = torch.autograd.grad(loss, list(net.parameters()))
        assert all(g.is_contiguous() for g in grads)
        steps.append(grads)
    assert kernels.launch_counts() == ZERO_COUNTS
    fused = tpk.FusedAdam(1e-3) if opt == "adam" else tpk.FusedSGD(0.05)
    kp = [p.clone() for p in params]
    state = fused.init(kp)
    rp = [p.clone() for p in params]
    rstate = fused.init(rp)
    for grads in steps:
        fused.fused_apply(kp, grads, state)
        if opt == "adam":
            tpk.adam_step_plain(rp, grads, *rstate, 1e-3, 0.9, 0.999, 1e-8)
        else:
            tpk.sgd_step_plain(rp, grads, 0.05)
    name = "adam_fused" if opt == "adam" else "sgd_fused"
    assert kernels.launch_counts() == {**ZERO_COUNTS, name: 2}
    assert fused._tables.builds == 1
    kept = list(state[0]) + list(state[1]) if opt == "adam" else []
    ref = list(rstate[0]) + list(rstate[1]) if opt == "adam" else []
    for a, b in zip(kp + kept, rp + ref, strict=True):
        assert torch.equal(a, b)
