"""nkbx's weight files in the port: the pretrained-backbone rule and nkbx
``.msgpack`` checkpoints.

- :func:`read_msgpack`: a reader of flax's msgpack format (flax
  ``serialization.msgpack_restore``): nested maps of str keys, ndarray
  leaves as ext type 1 (a msgpack tuple of shape, dtype name and row-major
  bytes), numpy scalars as ext type 3, complex numbers as ext type 2, and
  the ``__msgpack_chunked_array__`` dicts flax writes for arrays over 1 GiB.
  It needs no ``msgpack`` package. numpy has no bfloat16, so a bfloat16 leaf
  comes back widened to float32, exactly.
- :func:`write_msgpack`: its writer, the bytes ``flax.serialization.to_bytes``
  writes for a tree of maps and numpy arrays (map order kept, arrays over
  1 GiB as flax's chunk dicts), streamed to the file with no copy of a
  contiguous array and one of a strided view.
- The pretrained rule (nkbx ``registry.py:129-138, 170-177``): with
  ``pretrained=True`` a backbone takes ``$NKBX_PRETRAINED_DIR/<name>.msgpack``
  (:func:`default_filename`) when it exists: its ``params`` and
  ``batch_stats`` fill the backbone (the classifier head keeps its fresh
  init). Without it the backbone warns and keeps random weights. nkbx then
  tries to download and convert the torch weights (timm/unicom); the port
  downloads nothing.
- :func:`load_checkpoint`: ``get_model``'s ``checkpoint`` key (nkbx
  ``checkpoint.py:175-207``): a nkbx ``.msgpack`` weights file, the port's
  own ``.pt`` state dict or checkpoint directory; an orbax directory raises.

A ViT ``pos_embed`` saved at another token grid is resampled on every load,
as nkbx does (:func:`nkbx_torch.models.convert.adapt_variables_tree`); any
other tree or leaf shape that does not fit the model raises.
"""

from __future__ import annotations

import os
import struct
import warnings
from pathlib import Path

import numpy as np
import torch

from nkbx_torch.models.convert import adapt_variables_tree, from_jax_variables

# --- the msgpack reader ------------------------------------------------------------

_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3
_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: ">b", 0xD1: ">h", 0xD2: ">i",
          0xD3: ">q", 0xCA: ">f", 0xCB: ">d"}
_LEN = {1: ">B", 2: ">H", 4: ">I"}


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack data ends inside an object")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def length(self, nbytes: int) -> int:
        return self.unpack(_LEN[nbytes])

    def obj(self):
        b = self.unpack(">B")
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return [self.obj() for _ in range(b & 0x0F)]
        if 0xA0 <= b <= 0xBF:
            return str(self.take(b & 0x1F), "utf-8")
        if b == 0xC0:
            return None
        if b in (0xC2, 0xC3):
            return b == 0xC3
        if b in _FIXED:
            return self.unpack(_FIXED[b])
        if b in (0xC4, 0xC5, 0xC6):  # bin 8/16/32
            return bytes(self.take(self.length(1 << (b - 0xC4))))
        if b in (0xD9, 0xDA, 0xDB):  # str 8/16/32
            return str(self.take(self.length(1 << (b - 0xD9))), "utf-8")
        if b in (0xDC, 0xDD):  # array 16/32
            return [self.obj() for _ in range(self.length(2 << (b - 0xDC)))]
        if b in (0xDE, 0xDF):  # map 16/32
            return self.map(self.length(2 << (b - 0xDE)))
        if 0xD4 <= b <= 0xD8:  # fixext 1/2/4/8/16
            code = self.unpack(">b")
            return _ext(code, self.take(1 << (b - 0xD4)))
        if b in (0xC7, 0xC8, 0xC9):  # ext 8/16/32
            n = self.length(1 << (b - 0xC7))
            code = self.unpack(">b")
            return _ext(code, self.take(n))
        raise ValueError(f"msgpack byte 0x{b:02x} at offset {self.pos - 1} is not a valid type")

    def map(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            key = self.obj()
            out[key] = self.obj()
        return out


def _unpackb(data) -> object:
    r = _Reader(data)
    out = r.obj()
    if r.pos != len(r.data):
        raise ValueError(f"{len(r.data) - r.pos} bytes of msgpack data after the object")
    return out


def _ndarray(data) -> np.ndarray:
    shape, dtype_name, buf = _unpackb(data)
    name = dtype_name if isinstance(dtype_name, str) else dtype_name.decode()
    if name == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(name)).reshape(shape)


def _ext(code: int, data):
    if code == _EXT_NDARRAY:
        return _ndarray(data)
    if code == _EXT_NPSCALAR:
        return _ndarray(data)[()]
    if code == _EXT_COMPLEX:
        re, im = _unpackb(data)
        return complex(re, im)
    raise ValueError(f"msgpack ext type {code} is not flax's")


def _unchunk(tree):
    if isinstance(tree, dict):
        if "__msgpack_chunked_array__" in tree:
            shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def read_msgpack(path) -> dict:
    """The tree of a flax msgpack file (``flax.serialization.to_bytes``),
    numpy arrays at the leaves."""
    with open(path, "rb") as f:
        data = f.read()
    try:
        return _unchunk(_unpackb(data))
    except (ValueError, TypeError, struct.error, UnicodeDecodeError) as e:
        raise ValueError(f"{path}: not a readable flax msgpack file ({e})") from e


# --- the msgpack writer -------------------------------------------------------------

MAX_CHUNK_SIZE = 2 ** 30  # flax's: a leaf of more bytes is written as a chunk dict


def _head(n: int, small: int, small_max: int, wide: tuple) -> bytes:
    """A msgpack length header: the one-byte form ``small | n`` up to
    ``small_max``, else the first of ``wide`` ((code, struct format), ...)
    whose length field holds n."""
    if n <= small_max:
        return bytes([small | n])
    for code, fmt in wide:
        if n < 1 << (8 * struct.calcsize(fmt)):
            return bytes([code]) + struct.pack(fmt, n)
    raise ValueError(f"msgpack object of length {n} is too long")


def _uint(v: int) -> bytes:
    """A msgpack non-negative integer (array dims, a chunk dict's shape)."""
    return _head(v, 0, 127, ((0xCC, ">B"), (0xCD, ">H"), (0xCE, ">I"), (0xCF, ">Q")))


def _str(v: str) -> bytes:
    b = v.encode("utf-8")
    return _head(len(b), 0xA0, 31, ((0xD9, ">B"), (0xDA, ">H"), (0xDB, ">I"))) + b


def _ndarray_head(arr: np.ndarray) -> tuple:
    """(the ext header, the payload's head) of an ndarray leaf: flax packs
    (shape, dtype name, row-major bytes) as one msgpack object."""
    shape = _head(arr.ndim, 0x90, 15, ((0xDC, ">H"), (0xDD, ">I")))
    shape += b"".join(_uint(int(d)) for d in arr.shape)
    body = (b"\x93" + shape + _str(arr.dtype.name)
            + _head(arr.nbytes, 0, -1, ((0xC4, ">B"), (0xC5, ">H"), (0xC6, ">I"))))
    return body, len(body) + arr.nbytes


def _ext_head(code: int, n: int) -> bytes:
    if n in (1, 2, 4, 8, 16):
        return bytes([0xD4 + n.bit_length() - 1, code])
    return _head(n, 0, -1, ((0xC7, ">B"), (0xC8, ">H"), (0xC9, ">I"))) + bytes([code])


def _write(f, obj):
    if isinstance(obj, dict):
        f.write(_head(len(obj), 0x80, 15, ((0xDE, ">H"), (0xDF, ">I"))))
        for key, value in obj.items():
            f.write(_str(str(key)))
            _write(f, value)
    elif isinstance(obj, np.ndarray) and obj.nbytes > MAX_CHUNK_SIZE:
        flat = obj.reshape(-1)
        size = max(1, MAX_CHUNK_SIZE // obj.dtype.itemsize)
        _write(f, {"__msgpack_chunked_array__": True,
                   "shape": {str(i): d for i, d in enumerate(obj.shape)},
                   "chunks": {str(i): flat[j:j + size]
                              for i, j in enumerate(range(0, flat.size, size))}})
    elif isinstance(obj, np.ndarray):
        arr = obj if obj.flags.c_contiguous else np.ascontiguousarray(obj)  # a view: one copy
        if arr.dtype.hasobject or arr.dtype.isalignedstruct:
            raise ValueError("object and structured dtypes have no msgpack form")
        body, n = _ndarray_head(arr)
        f.write(_ext_head(_EXT_NDARRAY, n))
        f.write(body)
        f.write(memoryview(arr.reshape(-1)).cast("B"))
    elif isinstance(obj, bool):  # a chunk dict's flag
        f.write(b"\xc3" if obj else b"\xc2")
    elif isinstance(obj, int):  # a chunk dict's shape
        f.write(_uint(obj))
    else:
        raise TypeError(f"a weights tree holds maps and numpy arrays, not {type(obj).__name__}")


def write_msgpack(tree: dict, path):
    """Write a tree of maps and numpy arrays as flax's msgpack format
    (``flax.serialization.to_bytes``), which nkbx and :func:`read_msgpack`
    read."""
    with open(path, "wb") as f:
        _write(f, tree)


# --- loading a flax tree into a module ----------------------------------------------


def load_flax_tree(module: torch.nn.Module, tree: dict, what: str, stats_required: bool = True):
    """Copy a nkbx ``{'params': ..., 'batch_stats': ...}`` tree into
    ``module`` through :func:`from_jax_variables`. Every parameter must be
    there, and every running statistic unless ``stats_required`` is False
    and the tree holds none; nothing may be left over. A ``pos_embed`` at
    another token grid is resampled; any other leaf whose shape differs
    raises."""
    stats = tree.get("batch_stats") or {}
    sd = from_jax_variables({"params": tree.get("params") or {}, "batch_stats": stats})
    ref = module.state_dict()
    want = set(ref) if (stats or stats_required) else {n for n, _ in module.named_parameters()}
    missing, leftover = sorted(want - set(sd)), sorted(set(sd) - set(ref))
    if missing or leftover:
        raise ValueError(f"{what}: the file's tree does not fit the model (missing {missing[:5]}"
                         f"{' ...' if len(missing) > 5 else ''}, leftover {leftover[:5]}"
                         f"{' ...' if len(leftover) > 5 else ''}); was it saved from a different "
                         "architecture?")
    module.load_state_dict(_adapted(sd, {k: ref[k] for k in sd}, what), strict=False)


def _adapted(sd: dict, ref: dict, what: str) -> dict:
    """``sd`` fitted onto ``ref``'s shapes by
    :func:`~nkbx_torch.models.convert.adapt_variables_tree` (a ``pos_embed``
    at another token grid resampled), its errors naming ``what``."""
    try:
        return adapt_variables_tree(sd, ref)
    except ValueError as e:
        raise ValueError(f"{what}: {e}") from None



# --- the pretrained rule ------------------------------------------------------------


def default_filename(name: str) -> str:
    """The converted file's name for a backbone name (nkbx convert.py:702-705)."""
    return name.replace("/", "_").replace(" ", "_") + ".msgpack"


def pretrained_params_path(name: str):
    """``$NKBX_PRETRAINED_DIR/<default_filename(name)>`` if it exists, else None."""
    d = os.environ.get("NKBX_PRETRAINED_DIR", "")
    if not d:
        return None
    p = os.path.join(d, default_filename(name))
    return p if os.path.exists(p) else None


def warn_no_pretrained(name: str):
    warnings.warn(
        f"pretrained=True but no converted checkpoint for {name!r} under "
        f"$NKBX_PRETRAINED_DIR — initializing randomly. Convert torch "
        f"weights with `python -m nkbx_torch.models.convert --model {name!r} "
        f"--weights <torch file>` (nkbx_torch's converter). nkbx_torch downloads nothing: "
        f"nkbx's transparent timm/unicom fetch is not ported.")


def load_pretrained_into(backbone: torch.nn.Module, path):
    """A converted backbone file (nkbx ``load_pretrained_into``,
    convert.py:159-188) into ``backbone``: its params and batch_stats."""
    load_flax_tree(backbone, read_msgpack(path), f"pretrained weights {path}")


# --- get_model's checkpoint key -------------------------------------------------------


def load_checkpoint(module: torch.nn.Module, path):
    """Weights for ``module`` from ``path``: a nkbx ``.msgpack`` (params, and
    batch_stats where it holds them), the port's state dict file (``best.pt``)
    or the port's checkpoint directory (``weights/best``: its
    ``train_state.pt``). An orbax directory raises."""
    from nkbx_torch.train.checkpoint import STATE_FILE

    path = Path(path)
    if path.is_dir():
        if not (path / STATE_FILE).exists():
            raise NotImplementedError(
                f"checkpoint {path} is a directory without {STATE_FILE}: an orbax checkpoint of "
                "nkbx, which nkbx_torch cannot read (no orbax); save nkbx's weights as a "
                ".msgpack (nkbx.train.checkpoint.save_model_msgpack) and point checkpoint at it")
        sd = torch.load(path / STATE_FILE, map_location="cpu", weights_only=True)["module"]
    elif path.suffix == ".msgpack":
        load_flax_tree(module, read_msgpack(path), f"checkpoint {path}", stats_required=False)
        return
    else:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    module.load_state_dict(_adapted(sd, module.state_dict(), f"checkpoint {path}"))
