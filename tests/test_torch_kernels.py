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
    kernels.reset_launch_counts()
    x, g, b = _ln_inputs((16, 128))
    tln.fused_layer_norm(*(torch.from_numpy(a) for a in (x, g, b)))
    tfa.flash_attention(*(torch.from_numpy(a) for a in _qkv()), causal=True)
    assert kernels.launch_counts() == {"layernorm_fwd": 0, "flash_fwd": 0}
    assert tfa.effective_path(64, 64, "cpu") == ("plain", 64, 64)
    assert tfa.effective_path(200, 64, "cuda") == ("flash", 64, 64)
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
    assert kernels.launch_counts() == {"layernorm_fwd": 32000, "flash_fwd": 0}
    kernels.reset_launch_counts()


def test_kernel_wrappers_refuse_cpu_tensors():
    """The launch wrappers never fall back: a CPU tensor is a caller error
    there (the public functions route CPU tensors to the plain path)."""
    x, g, b = (torch.from_numpy(a) for a in _ln_inputs((8, 128)))
    with pytest.raises(ValueError, match="CUDA"):
        tln.layernorm_fwd(x, g, b, 1e-5)
    with pytest.raises(ValueError, match="CUDA"):
        tfa.flash_fwd(*(torch.from_numpy(a) for a in _qkv()), True)
    with pytest.raises(NotImplementedError, match="training slice"):
        tln._LayerNormFwd.backward(None, x)
    with pytest.raises(NotImplementedError, match="training slice"):
        tfa._FlashFwd.backward(None, x)


def test_kernel_sources_target_hopper():
    """Each kernel builds from a CUDA source in this checkout, for sm_90a,
    through a plain C launcher the wrapper binds."""
    assert build.ARCH_FLAGS == ["-gencode", "arch=compute_90a,code=sm_90a"]
    for name, (src, symbol, argtypes) in build.KERNELS.items():
        text = (build.CSRC / src).read_text()
        assert f'extern "C" int {symbol}(' in text
        assert "torch" not in text  # no PyTorch headers: seconds to build
        assert build.CSRC == Path(tfa.__file__).parents[1] / "kernels" / "csrc"
    assert set(build.KERNELS) == set(kernels.LAUNCHES)


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
