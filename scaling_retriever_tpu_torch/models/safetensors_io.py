"""The safetensors file format, read and written with torch and ``json``
alone (the machine with the card has no ``safetensors`` package).

A file is an 8-byte little-endian header length, a JSON header mapping
each tensor name to its ``dtype``, ``shape`` and ``data_offsets`` (a
[begin, end) byte range counted from the end of the header; an optional
``__metadata__`` entry holds strings), padded with spaces to a multiple of
8 bytes, then the raw little-endian tensor bytes.
"""

from __future__ import annotations

import json
import struct
from typing import Dict, Iterable, Iterator, Optional, Tuple

import torch

DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
    "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}
_NAMES = {v: k for k, v in DTYPES.items()}


def read_header(f) -> Tuple[dict, int]:
    """(header without ``__metadata__``, byte offset of the data)."""
    (n,) = struct.unpack("<Q", f.read(8))
    header = json.loads(f.read(n))
    header.pop("__metadata__", None)
    return header, 8 + n


def iter_tensors(path: str) -> Iterator[Tuple[str, torch.Tensor]]:
    """Yield (name, CPU tensor) in file order, one tensor read at a time,
    so a caller that copies each away holds one tensor on the host."""
    with open(path, "rb") as f:
        header, base = read_header(f)
        for name, meta in sorted(header.items(),
                                 key=lambda kv: kv[1]["data_offsets"][0]):
            if meta["dtype"] not in DTYPES:
                raise ValueError(f"{path}: {name} has unsupported dtype "
                                 f"{meta['dtype']!r}")
            begin, end = meta["data_offsets"]
            buf = torch.empty(end - begin, dtype=torch.uint8)
            f.seek(base + begin)
            if f.readinto(buf.numpy()) != end - begin:
                raise ValueError(f"{path}: {name} is truncated")
            yield name, buf.view(DTYPES[meta["dtype"]]).reshape(meta["shape"])


def load_file(path: str) -> Dict[str, torch.Tensor]:
    return dict(iter_tensors(path))


def save_file(tensors: Iterable[Tuple[str, torch.Tensor]] | dict, path: str,
              metadata: Optional[dict] = None) -> None:
    """Write (name, tensor) pairs, on any device, in the order given; each
    tensor is copied to the host only while it is written."""
    items = list(tensors.items() if isinstance(tensors, dict) else tensors)
    header: dict = {"__metadata__": dict(metadata or {"format": "pt"})}
    offset = 0
    for name, t in items:
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for _, t in items:
            host = t.detach().contiguous().cpu().reshape(-1)
            if host.numel():
                f.write(host.view(torch.uint8).numpy())
