"""Weight-only int8 / int4 matrices for the serving path (PyTorch port of
``distkeras_tpu.ops.quantization``).

Same scheme as the JAX package: symmetric per-output-column scales. An
int8 matrix is the dict ``{"q": int8 (in, out), "s": f32 (out,)}`` with
``w ~= q * s[None, :]``; an int4 matrix is an :class:`Int4Weight`, two
4-bit values per byte along the IN dimension (row 2i in the low nibble,
row 2i+1 in the high). Because the scale is per output column it commutes
through the product, so ``qmatmul`` never materializes the dequantized
matrix. The product itself is a plain ``torch.matmul``, as the JAX
package leaves it to XLA: no hand-written kernel sits on it.
"""

from __future__ import annotations

import torch


class Int4Weight:
    """Packed int4 weight: ``q4`` int8 (ceil(in/2), out), ``s`` f32
    (out,) per-column scales, ``rows`` the logical in dimension."""

    def __init__(self, q4, s, rows):
        self.q4, self.s, self.rows = q4, s, int(rows)


def quantize_int8(w):
    """f32 (in, out) -> {"q": int8, "s": f32 (out,)}, symmetric."""
    if w.ndim != 2:
        raise ValueError(f"quantize_int8 expects a 2-D matrix; got {tuple(w.shape)}")
    s = w.abs().amax(dim=0) / 127.0
    s = torch.where(s == 0, torch.ones_like(s), s).float()
    q = torch.clamp(torch.round(w / s[None, :]), -127, 127).to(torch.int8)
    return {"q": q, "s": s}


def quantize_int4(w):
    """f32 (in, out) -> Int4Weight, symmetric, range [-7, 7]; an odd in
    dimension pads one zero row before packing."""
    if w.ndim != 2:
        raise ValueError(f"quantize_int4 expects a 2-D matrix; got {tuple(w.shape)}")
    rows, cols = w.shape
    s = w.abs().amax(dim=0) / 7.0
    s = torch.where(s == 0, torch.ones_like(s), s).float()
    q = torch.clamp(torch.round(w / s[None, :]), -7, 7).to(torch.int32)
    if rows % 2:
        q = torch.cat([q, q.new_zeros((1, cols))], dim=0)
    packed = ((q[1::2] << 4) | (q[0::2] & 0x0F)).to(torch.int8)
    return Int4Weight(packed, s, rows)


def _unpack_int4(w):
    """Int4Weight -> int8 (rows, out): the low nibble sign-extends by
    (n ^ 8) - 8, the high one by an arithmetic shift of the signed byte."""
    p = w.q4.to(torch.int32)
    lo = ((p & 0x0F) ^ 8) - 8
    hi = p >> 4
    inter = torch.stack([lo, hi], dim=1).reshape(-1, p.shape[1])
    return inter[: w.rows].to(torch.int8)


def is_quantized(w) -> bool:
    return isinstance(w, Int4Weight) or (
        isinstance(w, dict) and "q" in w and "s" in w
    )


def dequantize(w):
    """Quantized form -> f32 matrix (testing/debugging)."""
    if isinstance(w, Int4Weight):
        return _unpack_int4(w).float() * w.s[None, :]
    return w["q"].float() * w["s"][None, :]


def qshape(w):
    """Logical shape of a weight that may or may not be quantized."""
    if isinstance(w, Int4Weight):
        return (w.rows, w.q4.shape[1])
    return tuple(w["q"].shape) if is_quantized(w) else tuple(w.shape)


def qmatmul(x, w):
    """x @ w for a plain or quantized w, in x.dtype."""
    if isinstance(w, Int4Weight):
        return (x @ _unpack_int4(w).to(x.dtype)) * w.s.to(x.dtype)
    if is_quantized(w):
        return (x @ w["q"].to(x.dtype)) * w["s"].to(x.dtype)
    return x @ w.to(x.dtype)
