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

A port model holds a quantized weight as a plain attribute of its layer
where the f32 ``nn.Parameter`` was (``quantize_model`` swaps them in
place); ``params_tree`` reads a model back as the JAX package's params
tree (``{"0": {...}, "1": {"mhsa": {"wq": ...}}}``), quantized leaves
included, which is what ``quantize_params`` and the serving bundles take.
"""

from __future__ import annotations

import numpy as np
import torch

#: the dict keys whose 2-D float leaves ``quantize_params`` quantizes: the
#: ``Dense`` kernels and the attention projections
DEFAULT_QUANT_KEYS = ("kernel", "wq", "wk", "wv", "wo")


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


def count_quantized(params) -> int:
    """Number of quantized matrices in a params tree, or held by a
    model's layers."""
    if isinstance(params, torch.nn.Module):
        return sum(
            is_quantized(v)
            for m in params.modules()
            for k, v in vars(m).items() if not k.startswith("_")
        )
    if is_quantized(params):
        return 1
    if isinstance(params, dict):
        return sum(count_quantized(v) for v in params.values())
    if isinstance(params, (list, tuple)):
        return sum(count_quantized(v) for v in params)
    return 0


def _quantizable(v) -> bool:
    if isinstance(v, torch.Tensor):
        return v.ndim == 2 and v.is_floating_point()
    if isinstance(v, np.ndarray):
        return v.ndim == 2 and np.issubdtype(v.dtype, np.floating)
    return False


def _quantizer(bits):
    if bits not in (8, 4):
        raise ValueError(f"bits must be 8 or 4; got {bits}")
    return quantize_int8 if bits == 8 else quantize_int4


def quantize_params(params, keys=DEFAULT_QUANT_KEYS, bits=8):
    """Walk a params tree; replace eligible 2-D float leaves (dict key in
    ``keys``; torch tensors or numpy arrays) with their ``bits``-wide
    form (8 or 4), as tensors. Already-quantized entries pass through
    unchanged — a tree quantized at one width is not re-quantized at
    another. Returns a new tree; the input is not mutated."""
    quant = _quantizer(bits)
    if is_quantized(params):
        return params
    if isinstance(params, dict):
        out = {}
        for k, v in params.items():
            if k in keys and _quantizable(v):
                w = v if isinstance(v, torch.Tensor) else torch.from_numpy(
                    np.array(v))
                out[k] = quant(w.detach())
            else:
                out[k] = quantize_params(v, keys, bits)
        return out
    if isinstance(params, (list, tuple)):
        return type(params)(quantize_params(v, keys, bits) for v in params)
    return params


def _layer_tree(module):
    tree = dict(module.named_parameters(recurse=False))
    tree.update((k, v) for k, v in vars(module).items()
                if not k.startswith("_") and is_quantized(v))
    for name, child in module.named_children():
        tree[name] = _layer_tree(child)
    return tree


def params_tree(model) -> dict:
    """The model's weights as the JAX package's params tree: one dict per
    layer keyed ``"0".."N"``, sublayers by their names, leaves the live
    parameters (or quantized weights). Layers without weights are empty
    dicts, as in JAX."""
    return {str(i): _layer_tree(layer) for i, layer in enumerate(model.layers)}


def quantize_model(model, keys=DEFAULT_QUANT_KEYS, bits=8):
    """Swap a built model's eligible weights for their int8/int4 forms IN
    PLACE and return the model. Serve-only: trainers refuse quantized
    models; quantize a copy (``quantize_model(m.copy())``) if the
    original must keep training."""
    if getattr(model, "output_shape", None) is None:
        raise ValueError("quantize_model needs a BUILT model (params set)")
    quant = _quantizer(bits)
    for module in list(model.modules()):
        for name, p in list(module.named_parameters(recurse=False)):
            if name in keys and _quantizable(p):
                q = quant(p.detach())
                delattr(module, name)
                setattr(module, name, q)
    return model


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
