"""The wire format of one document of arrays, as in the JAX package's
``runtime/wire.py`` (``WireError``, ``serialize_doc``,
``deserialize_doc``): the spill tier (``decode/spill.py``) keeps each
spilled KV block as one such document in host RAM.

One document is one npz byte string. Each array rides as the raw bytes
of its storage, a flat ``uint8`` entry; a JSON header (one more entry)
records each array's dtype name, shape and CRC-32, and carries every
other key of the document (ints, strings, None, ...) as is. The layout,
``WIRE_VERSION`` and the CRCs are JAX's, so a document written here is
read by the JAX package's ``deserialize_doc`` and back.

Arrays are ``torch.Tensor`` or ``numpy.ndarray`` on the way in and CPU
``torch.Tensor`` on the way out. ``bfloat16``, which numpy lacks, travels
as its 2-byte words under the header dtype ``bfloat16`` and comes back
through ``torch``'s own bf16 type. ``deserialize_doc`` rejects a torn
byte string, a bad header, another wire version, a missing array or a CRC
mismatch with a one-line ``WireError``.
"""

from __future__ import annotations

import io
import json
import zlib

import numpy as np
import torch

WIRE_VERSION = 1

# the npz entry holding the JSON header
_HEADER_ENTRY = "__wire_header__"

# the header's dtype names (numpy's, which JAX writes) of the pool's
# storage types and scales, and their torch types
_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
_NAMES = {v: k for k, v in _DTYPES.items()}


class WireError(ValueError):
    """A wire document failed an integrity or version check; the message
    is one line naming what failed."""


def _raw(arr) -> tuple[str, list[int], np.ndarray]:
    """``(dtype name, shape, flat uint8 bytes)`` of one array."""
    if isinstance(arr, torch.Tensor):
        if arr.dtype not in _NAMES:
            raise ValueError(f"no wire name for torch dtype {arr.dtype}")
        t = arr.detach().to("cpu").contiguous()
        return (_NAMES[t.dtype], list(t.shape),
                t.reshape(-1).view(torch.uint8).numpy())
    buf = np.ascontiguousarray(arr)
    return str(arr.dtype), list(arr.shape), buf.view(np.uint8).reshape(-1)


def serialize_doc(doc: dict) -> bytes:
    """One document -> its npz wire bytes. Array values (torch or numpy)
    become byte entries with their dtype, shape and CRC-32 in the header;
    the other values ride in the header as they are."""
    header = {"wire_version": WIRE_VERSION, "meta": {}, "arrays": {}}
    payload = {}
    for name, val in doc.items():
        if not isinstance(val, (torch.Tensor, np.ndarray)):
            header["meta"][name] = val
            continue
        if name == _HEADER_ENTRY:
            raise ValueError(f"array name {name!r} collides with the "
                             "wire header entry")
        dtype, shape, raw = _raw(val)
        header["arrays"][name] = {"dtype": dtype, "shape": shape,
                                  "crc32": zlib.crc32(raw.tobytes())}
        payload[name] = raw
    hdr = np.frombuffer(json.dumps(header).encode("utf-8"), np.uint8)
    out = io.BytesIO()
    np.savez(out, **{_HEADER_ENTRY: hdr}, **payload)
    return out.getvalue()


def deserialize_doc(data: bytes) -> dict:
    """The npz wire bytes -> the document, every array CRC-checked and
    returned as a CPU tensor of its recorded dtype and shape. Raises
    ``WireError`` on a torn or truncated byte string, a missing or
    unreadable header, another wire version, a missing or unreadable
    array, an unknown dtype or a CRC mismatch."""
    try:
        npz = np.load(io.BytesIO(data), allow_pickle=False)
    except Exception as e:  # noqa: BLE001 - any load failure is a torn doc
        raise WireError(f"unreadable wire doc (torn/truncated npz): "
                        f"{type(e).__name__}: {e}") from None

    def entry(name: str):
        # the zip container checks its own CRC when an entry is read
        try:
            return npz[name]
        except Exception as e:  # noqa: BLE001 - any read failure
            raise WireError(f"array {name!r} unreadable (corrupted "
                            f"npz entry): {type(e).__name__}: "
                            f"{e}") from None

    with npz:
        if _HEADER_ENTRY not in npz.files:
            raise WireError("wire doc missing its header entry "
                            f"({_HEADER_ENTRY!r})")
        raw_header = bytes(entry(_HEADER_ENTRY))
        try:
            header = json.loads(raw_header.decode("utf-8"))
        except ValueError as e:     # UnicodeDecodeError is a ValueError
            raise WireError(f"wire doc header unparseable: "
                            f"{type(e).__name__}: {e}") from None
        if header.get("wire_version") != WIRE_VERSION:
            raise WireError(f"wire version {header.get('wire_version')!r} "
                            f"!= {WIRE_VERSION}")
        doc = dict(header.get("meta", {}))
        for name, spec in header.get("arrays", {}).items():
            if name not in npz.files:
                raise WireError(f"wire doc missing array {name!r}")
            raw = entry(name)
            got = zlib.crc32(raw.tobytes())
            if got != int(spec["crc32"]):
                raise WireError(
                    f"array {name!r} CRC-32 mismatch ({got:#010x} != "
                    f"recorded {int(spec['crc32']):#010x}) — corrupted "
                    "in transit")
            if spec["dtype"] not in _DTYPES:
                raise WireError(f"array {name!r} has unknown dtype "
                                f"{spec['dtype']!r}")
            t = torch.from_numpy(np.array(raw, np.uint8, copy=True))
            doc[name] = t.view(_DTYPES[spec["dtype"]]).reshape(
                spec["shape"])
    return doc
