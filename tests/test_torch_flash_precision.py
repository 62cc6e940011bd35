"""The f32 arithmetic of the flash forward kernel (``flash_fwd.cu``),
emulated in PyTorch on the CPU and held against the port's plain version.

The kernel runs both of its products on the tensor cores as 3xTF32
``mma.sync``: each f32 operand is split into hi = tf32(x) and lo =
tf32(x - hi), rounded on the integer pipe (add half a TF32 ulp to the
bits, clear the 13 low bits: ``to_tf32`` in ``flash_common.cuh``), and a.b
is taken as lo.hi + hi.lo + hi.hi with f32 accumulation (lo.lo dropped).
An infinite element would make a cross term inf * lo or inf * 0, so a
block that meets a non-finite value runs its loop again with the guarded
split, where such an element's lo and its hi in the cross terms are 0
(``_split``): the product is then the exact f32 one, and on finite inputs
nothing changes. Q is pre-scaled by 1/sqrt(D) in f32 before its split; P
is split straight from the f32 scores. The online softmax keeps m = -inf
for a row that has seen nothing (shift 0), divides by 1 where l = 0 and
gives lse = -inf there. This file checks that this arithmetic stays within
the card tests' tolerances (``chip_smoke.py``'s FLASH_TOL_O and
FLASH_TOL_LSE), which single-pass TF32 does not. The kernel itself is held
against the same plain version on the card (``test_torch_kernels.py``,
marker ``gpu``).
"""

import math

import numpy as np
import pytest
import torch

from distkeras_tpu_torch.ops import flash_attention as tfa

FLASH_TOL_O = 2e-5
FLASH_TOL_LSE = 1e-5
BLOCK_K = 64

torch.set_num_threads(2)


def _tf32(x):
    """cvt.rna.tf32.f32 as the kernel does it on the integer pipe."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def _split_plain(x):
    """The split the kernels' first pass runs: hi = tf32(x), lo = tf32(x -
    hi). An infinite x gives lo = tf32(inf - inf), not 0."""
    hi = _tf32(x)
    return hi, _tf32(x - hi)


def _split(x):
    """The guarded split (``Split<N, true>`` in ``flash_common.cuh``):
    (hi, fin, lo) with fin = hi, except that an infinite x keeps hi = +-inf
    and gets fin = 0 and lo = 0, and a NaN x stays NaN in all three. On a
    finite x it is the plain split, with fin = hi."""
    hi, lo = _split_plain(x)
    inf, nan = torch.isinf(x), torch.isnan(x)
    hi = torch.where(inf | nan, x, hi)
    fin = torch.where(inf, 0.0, hi)
    lo = torch.where(inf, 0.0, torch.where(nan, x, lo))
    return hi, fin, lo


def _mm3_plain(a, b):
    """a @ b as the first pass's 3xTF32 ``mma.sync``: lo.hi + hi.lo +
    hi.hi, f32 sums."""
    ah, al = _split_plain(a)
    bh, bl = _split_plain(b)
    return al @ bh + ah @ bl + ah @ bh


def _mm3(a, b):
    """a @ b as the kernels compute it: lo.fin + fin.lo + hi.hi with the
    guarded split. Only hi.hi sees an infinite element, so the result is
    the exact f32 product's +-inf (or NaN for inf * 0). On finite inputs it
    is ``_mm3_plain`` bit for bit: that is what the kernels' first pass
    gives, and a second, guarded pass runs only after a non-finite value."""
    ah, af, al = _split(a)
    bh, bf, bl = _split(b)
    return al @ bf + af @ bl + ah @ bh


def _mm1(a, b):
    """a @ b in one TF32 pass (what the kernel does not do)."""
    return _tf32(a) @ _tf32(b)


def emulate_flash_fwd(q, k, v, causal, mm=_mm3, empty=()):
    """The kernel's f32 forward on (B, T, H, D) tensors: Q pre-scaled,
    64-key tiles, online softmax with the -inf guards; ``empty`` lists
    (b, t, h) query rows that see no key at all. Returns (O (B, T, H, D),
    lse (B, H, T, 1)) like ``_reference_flash_fwd``."""
    b, t, h, d = q.shape
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    qs = (q * scale).transpose(1, 2)  # (B, H, T, D), pre-scaled in f32
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    visible = torch.ones(b, h, t, t, dtype=torch.bool)
    if causal:
        visible &= torch.ones(t, t, dtype=torch.bool).tril()
    for bi, ti, hi in empty:
        visible[bi, hi, ti] = False
    m = torch.full((b, h, t), float("-inf"))
    l = torch.zeros(b, h, t)
    acc = torch.zeros(b, h, t, d)
    for k0 in range(0, t, BLOCK_K):
        s = mm(qs, kt[:, :, k0:k0 + BLOCK_K].transpose(-1, -2))
        s = s.masked_fill(~visible[..., k0:k0 + BLOCK_K], float("-inf"))
        m_new = torch.maximum(m, s.amax(-1))
        shift = torch.where(torch.isneginf(m_new), 0.0, m_new)
        corr = torch.exp(torch.where(torch.isneginf(m), shift, m) - shift)
        p = torch.exp(s - shift[..., None])
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + mm(p, vt[:, :, k0:k0 + BLOCK_K])
        m = m_new
    l_safe = torch.where(l == 0, 1.0, l)
    o = acc * (1.0 / l_safe)[..., None]
    lse = torch.where(torch.isneginf(m), float("-inf"), m + torch.log(l_safe))
    return o.transpose(1, 2), lse[..., None]


def _qkv(shape, seed):
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
            for _ in range(3)]


CASES = [((2, 200, 8, 64), True), ((1, 512, 2, 64), False),
         ((2, 100, 4, 36), True)]


def test_tf32_rounding_and_split():
    """to_tf32 keeps 10 mantissa bits, rounding half away from zero (like
    cvt.rna), and hi + lo carries x to within 2^-21 of |x|."""
    one = torch.tensor([1.0, -1.0])
    half_ulp = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11)])
    below = torch.tensor([1 + 2.0 ** -12])
    assert _tf32(one).tolist() == [1.0, -1.0]
    assert _tf32(half_ulp).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10)]
    assert _tf32(below).tolist() == [1.0]
    x = _qkv((4096,), 0)[0] * 100
    hi, lo = _split_plain(x)
    assert bool(((hi.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((lo.view(torch.int32) & 0x1FFF) == 0).all())
    assert bool(((hi + lo - x).abs() <= 2.0 ** -21 * x.abs()).all())


@pytest.mark.parametrize("shape,causal", CASES)
def test_3xtf32_forward_within_card_tolerances(shape, causal):
    """The emulated kernel arithmetic against the plain forward: O within
    FLASH_TOL_O and lse within FLASH_TOL_LSE, absolute."""
    q, k, v = _qkv(shape, seed=shape[1])
    o, lse = emulate_flash_fwd(q, k, v, causal)
    ro, rlse = tfa._reference_flash_fwd(q, k, v, causal)
    assert float((o - ro).abs().max()) <= FLASH_TOL_O
    assert float((lse - rlse).abs().max()) <= FLASH_TOL_LSE


@pytest.mark.parametrize("shape,causal", CASES)
def test_single_pass_tf32_misses_the_tolerances(shape, causal):
    """One TF32 pass keeps ~3 digits: it misses the tolerances the 3xTF32
    path meets, so those tolerances tell the two apart."""
    q, k, v = _qkv(shape, seed=shape[1])
    o, lse = emulate_flash_fwd(q, k, v, causal, mm=_mm1)
    ro, rlse = tfa._reference_flash_fwd(q, k, v, causal)
    assert float((lse - rlse).abs().max()) > 10 * FLASH_TOL_LSE
    assert float((o - ro).abs().max()) > FLASH_TOL_O


@pytest.mark.parametrize("causal", [True, False])
def test_row_that_attends_nothing_keeps_the_guards(causal):
    """A query row that sees no key keeps m = -inf through every tile
    (shift 0, so no exp(-inf - -inf)), divides by 1 where l = 0: O = 0 and
    lse = -inf, with nothing NaN; every other row is as before."""
    shape = (2, 130, 4, 64)
    q, k, v = _qkv(shape, seed=7)
    empty = [(0, 5, 1), (1, 129, 3), (1, 0, 0)]
    o, lse = emulate_flash_fwd(q, k, v, causal, empty=empty)
    ro, rlse = tfa._reference_flash_fwd(q, k, v, causal)
    assert torch.isfinite(o).all() and not torch.isnan(lse).any()
    keep = torch.ones(shape[:3], dtype=torch.bool)
    for b, t, h in empty:
        assert bool((o[b, t, h] == 0).all())
        assert float(lse[b, h, t, 0]) == float("-inf")
        keep[b, t, h] = False
    assert float((o - ro).abs()[keep].max()) <= FLASH_TOL_O
    lkeep = keep.transpose(1, 2)[..., None]
    assert float((lse - rlse).abs()[lkeep].max()) <= FLASH_TOL_LSE


def test_guarded_split_is_the_plain_split_on_finite_inputs():
    """On finite operands the guarded product is the plain one bit for bit
    (the mask is the identity there), in the product and through the
    whole emulated forward."""
    a, b = _qkv((2, 96, 64), 5)[:2]
    a = a * torch.logspace(-20, 20, 64)
    hi, fin, lo = _split(a)
    phi, plo = _split_plain(a)
    assert torch.equal(hi, phi) and torch.equal(fin, phi)
    assert torch.equal(lo, plo)
    assert torch.equal(_mm3(a, b.transpose(-1, -2)),
                       _mm3_plain(a, b.transpose(-1, -2)))
    q, k, v = _qkv((1, 130, 2, 64), seed=6)
    for got, want in zip(emulate_flash_fwd(q, k, v, True),
                         emulate_flash_fwd(q, k, v, True, mm=_mm3_plain)):
        assert torch.equal(got, want)


def test_guarded_product_of_infinite_elements_is_exact():
    """+-inf in either operand: the guarded product gives what the f32
    product gives (+-inf, NaN for inf * 0 or inf - inf); the plain split
    turns such entries NaN (inf * lo); finite entries are unchanged."""
    a = torch.tensor([[float("inf"), 1.5, -2.0],
                      [float("-inf"), 0.25, 3.0],
                      [float("inf"), 0.0, 1.0],
                      [1.0, -1.0, 0.5]])
    b = torch.tensor([[2.0, 0.0, -1e-3, float("inf")],
                      [1.0, 3.0, 2.0, 1.0],
                      [0.5, -1.0, 4.0, 1.0]])
    want, got = a @ b, _mm3(a, b)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    inf = torch.isinf(want)
    assert torch.equal(got[inf], want[inf])
    fin = torch.isfinite(want)
    assert float((got - want)[fin].abs().max()) <= 1e-6
    assert bool(torch.isnan(_mm3_plain(a, b)[inf]).any())


def _infinite_q_row(causal):
    """q, k, v (1, 16, 1, 64) f32 from ``default_rng(3)`` with every key's
    first component negative and q row 5 = (+inf, 0, ..., 0): each score
    of that row is inf * (negative) + 0 = -inf, so the row attends
    nothing, as in the JAX kernel."""
    q, k, v = _qkv((1, 16, 1, 64), seed=3)
    k[..., 0] = -k[..., 0].abs() - 0.5
    q[0, 5, 0] = 0.0
    q[0, 5, 0, 0] = float("inf")
    return q, k, v


@pytest.mark.parametrize("causal", [True, False])
def test_infinite_q_element_gives_a_row_that_attends_nothing(causal):
    """An infinite q element (no forced ``empty`` row): with the guarded
    product the row's scores are -inf, so O = 0 and lse = -inf as in JAX's
    kernel and in the plain version; the plain split gives that row NaN.
    Every other row is within the card tolerances."""
    q, k, v = _infinite_q_row(causal)
    o, lse = emulate_flash_fwd(q, k, v, causal)
    ro, rlse = tfa._reference_flash_fwd(q, k, v, causal)
    assert bool((o[0, 5, 0] == 0).all()) and bool((ro[0, 5, 0] == 0).all())
    assert float(lse[0, 0, 5, 0]) == float(rlse[0, 0, 5, 0]) == float("-inf")
    keep = torch.ones(16, dtype=torch.bool)
    keep[5] = False
    assert float((o - ro)[0, keep].abs().max()) <= FLASH_TOL_O
    assert float((lse - rlse)[0, 0, keep].abs().max()) <= FLASH_TOL_LSE
    po, _ = emulate_flash_fwd(q, k, v, causal, mm=_mm3_plain)
    assert bool(torch.isnan(po[0, 5, 0]).all())
