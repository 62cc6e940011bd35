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
     "flash_bwd_dkv", "adam_fused"], 0)

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
                       tpk._AdamTable())
    with pytest.raises(NotImplementedError, match="B1/B2"):
        tpk.FusedSGD(0.01)


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
    assert build._library_path("flash_bwd_dq") == build._library_path("flash_bwd_dkv")
    assert "--use_fast_math" not in " ".join(build.ARCH_FLAGS)


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


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(8, 512), (4096, 512), (3, 96), (2, 2048)])
def test_layernorm_kernel_on_card(cuda_device, shape):
    x, g, b = (torch.from_numpy(a).to(cuda_device) for a in _ln_inputs(shape))
    got = tln.fused_layer_norm(x, g, b)
    ref = tln._reference_layer_norm(x, g, b, 1e-5)
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("t,causal", [(512, True), (512, False), (200, True), (1, True)])
def test_flash_kernel_on_card(cuda_device, t, causal):
    q, k, v = (torch.from_numpy(a).to(cuda_device)
               for a in _qkv(b=2, t=t, h=8, d=64))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    ro, rlse = tfa._reference_flash_fwd(q, k, v, causal)
    torch.testing.assert_close(o, ro, atol=2e-5, rtol=0)
    torch.testing.assert_close(lse, rlse, atol=1e-5, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("t,causal", [(512, True), (512, False), (200, True)])
def test_flash_bwd_kernels_on_card(cuda_device, t, causal):
    rng = np.random.default_rng(1)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, t, 8, 64))
                                    .astype(np.float32)).to(cuda_device)
                   for _ in range(4))
    o, lse = tfa.flash_fwd(q, k, v, causal)
    got = tfa.flash_bwd(q, k, v, o, lse, do, causal)
    ref = tfa._reference_flash_bwd(q, k, v, o, lse, do, causal)
    for a, r in zip(got, ref):
        tol = 1e-4 * max(1.0, float(r.abs().max()))
        torch.testing.assert_close(a, r, atol=tol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape,dtype", [((8, 512), torch.float32),
                                         ((4096, 512), torch.float32),
                                         ((4096, 512), torch.bfloat16),
                                         ((5, 96), torch.float32),
                                         ((3, 2048), torch.float32)])
def test_layernorm_bwd_kernel_on_card(cuda_device, shape, dtype):
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
