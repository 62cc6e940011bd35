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

``serialize_model`` and the serving bundles of the JAX module are not
ported yet.
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
    if obj is None:
        return {"t": "none"}
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
