"""Tree (de)serialization — pickle-free (PyTorch port of the tree codec of
``distkeras_tpu.utils.serialization``; a copy of its numpy code, which the
port may not import).

    frame   = MAGIC "DKT1" + 4-byte big-endian header length
            + JSON header + raw npz payload
    header  = {"tree": <structure node>} — a typed description of the tree
              (dict / list / tuple / namedtuple / None nodes, leaf indices)
    payload = np.savez of the numeric leaves, loaded with allow_pickle=False

Leaves are torch tensors (copied to the host) or anything ``np.asarray``
takes. For a tree of numpy arrays the bytes are the JAX encoder's, and
each side decodes the other's frames — the format of the checkpoints both
packages write, and of the parameter-server wire (DKT1).

NamedTuple nodes are encoded structurally by class path + field names. On
decode the class is imported ONLY when its module root is on a small
allowlist and the imported object really is a NamedTuple class with the
same fields; anything else — optax's states among them, since the port
imports no optax — degrades to an anonymous namedtuple with the same
fields: structurally equal, never an arbitrary constructor call.

``serialize_model``/``deserialize_model`` carry an f32 model (its
architecture spec JSON and its weights in the JAX leaf order); the serving
bundles carry a quantized one (the spec plus the quantized params tree,
``Int4Weight`` as a structural ``int4`` node). Both are the JAX module's
frames: a model or bundle written by either package loads in the other.
"""

from __future__ import annotations

import collections
import importlib
import io
import json
import struct

import numpy as np
import torch

_MAGIC = b"DKT1"
_HLEN = struct.Struct(">I")

# Module roots we are willing to import while decoding a namedtuple node.
_NT_MODULE_ALLOWLIST = ("distkeras_tpu_torch", "collections")


# ------------------------------------------------------------ structure codec


def _leaf_array(obj):
    if isinstance(obj, torch.Tensor):
        if obj.dtype == torch.bfloat16:
            raise TypeError("bfloat16 leaves are not serializable (numpy "
                            "has no bfloat16); cast to float32 first")
        return obj.detach().cpu().numpy()
    return np.asarray(obj)


def _encode_node(obj, leaves: list) -> dict:
    from distkeras_tpu_torch.ops.quantization import Int4Weight

    if obj is None:
        return {"t": "none"}
    if isinstance(obj, Int4Weight):
        # packed int4 weight: the two arrays ride the leaf stream, the
        # logical row count is structural metadata
        return {
            "t": "int4",
            "rows": int(obj.rows),
            "children": [
                _encode_node(obj.q4, leaves),
                _encode_node(obj.s, leaves),
            ],
        }
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # namedtuple
        cls = type(obj)
        return {
            "t": "nt",
            "cls": f"{cls.__module__}:{cls.__qualname__}",
            "fields": list(obj._fields),
            "children": [_encode_node(c, leaves) for c in obj],
        }
    if isinstance(obj, dict):
        keys = list(obj.keys())
        if not all(isinstance(k, str) for k in keys):
            raise TypeError("only str-keyed dicts are serializable")
        return {
            "t": "dict",
            "keys": keys,
            "children": [_encode_node(obj[k], leaves) for k in keys],
        }
    if isinstance(obj, (list, tuple)):
        return {
            "t": "list" if isinstance(obj, list) else "tuple",
            "children": [_encode_node(c, leaves) for c in obj],
        }
    arr = _leaf_array(obj)
    if arr.dtype.kind not in "biufc":
        raise TypeError(f"non-numeric leaf of dtype {arr.dtype} is not serializable")
    leaves.append(arr)
    return {"t": "leaf", "i": len(leaves) - 1}


def _resolve_namedtuple(path: str, fields: list):
    """Import the namedtuple class at ``module:qualname`` if (and only if)
    it is allowlisted and structurally matches; else build an anonymous
    stand-in with the same fields."""
    mod_name, _, qual = str(path).partition(":")
    if mod_name.split(".")[0] in _NT_MODULE_ALLOWLIST:
        try:
            obj = importlib.import_module(mod_name)
            for part in qual.split("."):
                obj = getattr(obj, part)
            if (
                isinstance(obj, type)
                and issubclass(obj, tuple)
                and getattr(obj, "_fields", None) == tuple(fields)
            ):
                return obj
        except Exception:  # noqa: BLE001 — any failure degrades
            pass
    name = qual.rsplit(".", 1)[-1] or "AnonymousState"
    if not name.isidentifier():
        name = "AnonymousState"
    return collections.namedtuple(name, fields, rename=True)


def _decode_node(node: dict, leaves: list):
    kind = node["t"]
    if kind == "none":
        return None
    if kind == "leaf":
        return leaves[node["i"]]
    children = [_decode_node(c, leaves) for c in node["children"]]
    if kind == "int4":
        from distkeras_tpu_torch.ops.quantization import Int4Weight

        return Int4Weight(children[0], children[1], int(node["rows"]))
    if kind == "dict":
        return dict(zip(node["keys"], children))
    if kind == "list":
        return children
    if kind == "tuple":
        return tuple(children)
    if kind == "nt":
        cls = _resolve_namedtuple(node["cls"], list(node["fields"]))
        return cls(*children)
    raise ValueError(f"unknown structure node type {kind!r}")


# -------------------------------------------------------------------- framing


def pack_frame(header: dict, blob: bytes = b"") -> bytes:
    """JSON header + raw binary payload in one length-framed buffer."""
    h = json.dumps(header).encode()
    return _MAGIC + _HLEN.pack(len(h)) + h + blob


def unpack_frame(data: bytes) -> tuple[dict, bytes]:
    if data[: len(_MAGIC)] != _MAGIC:
        raise ValueError("bad frame: missing DKT1 magic (refusing legacy pickle)")
    off = len(_MAGIC)
    (hlen,) = _HLEN.unpack_from(data, off)
    off += _HLEN.size
    header = json.loads(data[off : off + hlen].decode())
    return header, data[off + hlen :]


# ----------------------------------------------------------------- public API


def serialize_params(params) -> bytes:
    """Tree of tensors/arrays -> bytes (typed structure header + npz, no
    pickle)."""
    leaves: list = []
    tree = _encode_node(params, leaves)
    buf = io.BytesIO()
    np.savez(buf, **{f"a{i}": leaf for i, leaf in enumerate(leaves)})
    return pack_frame({"tree": tree}, buf.getvalue())


def deserialize_params(blob: bytes):
    """Bytes -> the tree, with numpy leaves."""
    header, payload = unpack_frame(blob)
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        leaves = [z[f"a{i}"] for i in range(len(z.files))]
    return _decode_node(header["tree"], leaves)


def save_params(path: str, params) -> None:
    with open(path, "wb") as f:
        f.write(serialize_params(params))


def load_params(path: str):
    with open(path, "rb") as f:
        return deserialize_params(f.read())


def serialize_model(model) -> bytes:
    """Sequential model -> bytes: architecture spec JSON + weight arrays
    (JAX leaf order)."""
    from distkeras_tpu_torch.ops.quantization import count_quantized

    if count_quantized(model):
        raise ValueError(
            "model holds an int8-quantized serving tree; quantization is a "
            "LOAD-TIME transform — serialize the f32 master and call "
            "ops.quantization.quantize_model after deserialize_model"
        )
    buf = io.BytesIO()
    np.savez(buf, *model.get_weights())
    return pack_frame(
        {
            "spec": json.dumps(model.get_config()),
            "input_shape": list(model.input_shape),
        },
        buf.getvalue(),
    )


def _rebuild(header, device):
    from distkeras_tpu_torch.models.sequential import Sequential

    model = Sequential.from_config(json.loads(header["spec"]))
    return model.build(tuple(header["input_shape"]), device=device)


def deserialize_model(blob: bytes, device=None):
    """Bytes -> a built model on ``device`` (None = CUDA)."""
    header, payload = unpack_frame(blob)
    if header.get("serving"):
        raise ValueError(
            "this frame is a quantized SERVING bundle, not an f32 "
            "model — load it with deserialize_serving_bundle / "
            "load_serving_bundle"
        )
    model = _rebuild(header, device)
    with np.load(io.BytesIO(payload), allow_pickle=False) as z:
        model.set_weights([z[k] for k in z.files])
    return model


# ------------------------------------------------------------ serving bundles


def serialize_serving_bundle(model) -> bytes:
    """Quantized model -> bytes: the deliberate counterpart of
    ``serialize_model``'s refusal of quantized trees. The frame carries
    the architecture spec plus the quantized params tree; it loads
    serve-only."""
    from distkeras_tpu_torch.ops.quantization import (
        count_quantized,
        params_tree,
    )

    if getattr(model, "output_shape", None) is None:
        raise ValueError("serving bundle needs a BUILT model")
    if not count_quantized(model):
        raise ValueError(
            "model is not quantized — a serving bundle stores the "
            "quantized tree (ops.quantization.quantize_model first); "
            "for the f32 master use serialize_model"
        )
    return pack_frame(
        {
            "spec": json.dumps(model.get_config()),
            "input_shape": list(model.input_shape),
            "serving": True,
        },
        serialize_params(params_tree(model)),
    )


def _shape(x) -> tuple:
    return tuple(x.shape) if isinstance(x, torch.Tensor) else np.shape(x)


def _dtype(x):
    if isinstance(x, torch.Tensor):
        return torch.empty(0, dtype=x.dtype).numpy().dtype
    return np.asarray(x).dtype


def _check_bundle(path, built, got) -> None:
    """Validate a loaded bundle tree against the spec-built model's:
    structure, shapes and dtypes, quantized leaves' internals included
    (a truncated q4 or a broadcastable scale would otherwise load and
    serve wrong numbers)."""
    from distkeras_tpu_torch.ops.quantization import (
        Int4Weight,
        is_quantized,
        qshape,
    )

    if is_quantized(got):
        want = _shape(built)
        if len(want) != 2:
            raise ValueError(
                f"serving bundle structure mismatch at {path}: quantized "
                f"leaf where the spec builds a {len(want)}-D array"
            )
        if tuple(qshape(got)) != want:
            raise ValueError(
                f"serving bundle shape mismatch at {path}: spec builds "
                f"{want}, bundle holds {tuple(qshape(got))}"
            )
        if isinstance(got, Int4Weight):
            q4_want = ((want[0] + 1) // 2, want[1])
            if (
                _shape(got.q4) != q4_want or _shape(got.s) != (want[1],)
                or _dtype(got.q4) != np.int8 or _dtype(got.s) != np.float32
            ):
                raise ValueError(
                    f"serving bundle int4 internals mismatch at {path}: "
                    f"q4 {_shape(got.q4)}/{_dtype(got.q4)} vs "
                    f"{q4_want}/int8, s {_shape(got.s)}/{_dtype(got.s)} "
                    f"vs ({want[1]},)/f32"
                )
        elif (
            _shape(got["s"]) != (want[1],) or _dtype(got["q"]) != np.int8
            or _dtype(got["s"]) != np.float32
        ):
            raise ValueError(
                f"serving bundle int8 internals mismatch at {path}: q "
                f"dtype {_dtype(got['q'])} vs int8, s {_shape(got['s'])}/"
                f"{_dtype(got['s'])} vs ({want[1]},)/f32"
            )
        return
    if isinstance(built, dict) != isinstance(got, dict) or (
        isinstance(built, dict) and set(built) != set(got)
    ):
        raise ValueError(f"serving bundle structure mismatch at {path}")
    if isinstance(built, dict):
        for k in built:
            _check_bundle(f"{path}/{k}", built[k], got[k])
    elif _shape(built) != _shape(got):
        raise ValueError(
            f"serving bundle shape mismatch at {path}: "
            f"{_shape(built)} vs {_shape(got)}"
        )
    elif _dtype(built) != _dtype(got):
        raise ValueError(
            f"serving bundle dtype mismatch at {path}: spec builds "
            f"{_dtype(built)}, bundle holds {_dtype(got)}"
        )


def _install(module, tree, device) -> None:
    """Put a validated bundle tree into a built model in place: f32
    leaves copy into the parameters, quantized leaves replace them."""
    from distkeras_tpu_torch.ops.quantization import Int4Weight, is_quantized

    def dev(a):
        return torch.from_numpy(np.array(a)).to(device)

    for name, value in tree.items():
        child = module._modules.get(name)
        if child is not None:
            _install(child, value, device)
        elif is_quantized(value):
            if isinstance(value, Int4Weight):
                q = Int4Weight(dev(value.q4), dev(value.s), value.rows)
            else:
                q = {"q": dev(value["q"]), "s": dev(value["s"])}
            delattr(module, name)
            setattr(module, name, q)
        else:
            with torch.no_grad():
                getattr(module, name).copy_(dev(value))


def deserialize_serving_bundle(blob: bytes, device=None):
    """Bytes -> a serve-only model on ``device`` (None = CUDA): the
    architecture rebuilt from the spec, its weights replaced by the
    stored quantized tree after validation against the spec-built
    model (same tree paths, shapes and dtypes)."""
    from distkeras_tpu_torch.ops.quantization import params_tree

    header, payload = unpack_frame(blob)
    if not header.get("serving"):
        raise ValueError(
            "not a serving bundle (use deserialize_model for f32 frames)"
        )
    model = _rebuild(header, device)
    loaded = deserialize_params(payload)
    _check_bundle("params", params_tree(model), loaded)
    _install(model, loaded, next(model.parameters()).device)
    return model


def save_serving_bundle(path: str, model) -> None:
    with open(path, "wb") as f:
        f.write(serialize_serving_bundle(model))


def load_serving_bundle(path: str, device=None):
    with open(path, "rb") as f:
        return deserialize_serving_bundle(f.read(), device=device)
