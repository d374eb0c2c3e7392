"""The port's own safetensors codec, and flat param-tree files.

The safetensors format: an 8-byte little-endian header length, a JSON
header ``{name: {"dtype", "shape", "data_offsets": [begin, end]}}`` (offsets
into the data that follows) with an optional ``"__metadata__"`` dict of
strings, then the raw little-endian bytes.  Files are read through a
copy-on-write memory map, one tensor at a time, straight into torch tensors
on the caller's device (bf16 included: numpy only carries its bits), so a
16 GB snapshot never sits in host memory twice.

Flat trees (counterpart of ``desta25_audio_tpu/ckpt/flat_io.py``): a nested
dict of tensors, int8 ``{"q", "s"}`` leaves included, is one file with
'/'-joined key paths.  bf16 leaves are stored as U16 and named in the
``desta_dtypes`` metadata, as the JAX package writes them, so either
package's files read with numpy-only safetensors readers.
"""

from __future__ import annotations

import json
import os
import struct
from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch

SEP = "/"

# safetensors dtype -> (torch dtype, numpy dtype of the same bytes)
_DTYPES = {
    "F64": (torch.float64, np.float64), "F32": (torch.float32, np.float32),
    "F16": (torch.float16, np.float16), "BF16": (torch.bfloat16, np.int16),
    "I64": (torch.int64, np.int64), "I32": (torch.int32, np.int32),
    "I16": (torch.int16, np.int16), "I8": (torch.int8, np.int8),
    "U8": (torch.uint8, np.uint8), "U16": (torch.uint16, np.uint16),
    "BOOL": (torch.bool, np.bool_),
}
_NAMES = {t: name for name, (t, _) in _DTYPES.items()}


def as_tensor(a) -> torch.Tensor:
    """A torch tensor, a numpy array (ml_dtypes bfloat16 included) or a
    scalar -> torch tensor (numpy arrays without a copy where torch can
    share them)."""
    if isinstance(a, torch.Tensor):
        return a
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)).view(
            torch.bfloat16)
    if not a.flags.writeable:
        a = a.copy()
    return torch.from_numpy(a)


# -- reading -------------------------------------------------------------------

def read_header(path: str) -> Tuple[Dict[str, Any], int]:
    """(header, data start) of one file; the metadata, where the file has
    any, sits under the header's ``"__metadata__"`` key."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
    return header, 8 + n


class SafetensorsFile:
    """One file, memory-mapped; ``get(name, device)`` reads one tensor."""

    def __init__(self, path: str):
        self.path = path
        header, self.start = read_header(path)
        self.metadata = header.pop("__metadata__", None) or {}
        self.entries = header
        self._mm = None

    def keys(self) -> List[str]:
        return list(self.entries)

    def _map(self):
        if self._mm is None:
            size = os.path.getsize(self.path) - self.start
            # mode "c": a private mapping torch may wrap without a copy
            self._mm = (np.memmap(self.path, np.uint8, "c", self.start, size)
                        if size else np.zeros(0, np.uint8))
        return self._mm

    def get(self, name: str, device="cpu") -> torch.Tensor:
        e = self.entries[name]
        t_dtype, n_dtype = _DTYPES[e["dtype"]]
        b, end = e["data_offsets"]
        raw = self._map()[b:end]
        if b % np.dtype(n_dtype).itemsize:
            raw = raw.copy()                      # an unaligned tensor
        t = torch.from_numpy(raw.view(n_dtype).reshape(e["shape"]))
        if t_dtype == torch.bfloat16:
            t = t.view(torch.bfloat16)
        device = torch.device(device)
        # off the map: a CPU tensor is copied, a device tensor uploaded
        return t.clone() if device.type == "cpu" else t.to(device)

    def close(self) -> None:
        self._mm = None


def load_safetensors(path: str, device="cpu") -> Dict[str, torch.Tensor]:
    f = SafetensorsFile(path)
    try:
        return {k: f.get(k, device) for k in f.keys()}
    finally:
        f.close()


def shard_files(path: str, exclude=()) -> List[str]:
    """One file, or every ``*.safetensors`` of a directory (sorted) whose
    name is not in ``exclude``."""
    if not os.path.isdir(path):
        return [path]
    return sorted(os.path.join(path, f) for f in os.listdir(path)
                  if f.endswith(".safetensors") and f not in exclude)


class SafetensorsState(Mapping):
    """A read-only ``{name: tensor}`` view over one file or a directory's
    shards (``hf_convert.py:42-58`` of the JAX package, which loads them
    whole): each lookup reads that tensor from its shard's memory map onto
    ``device``, so a converter streams the checkpoint tensor by tensor."""

    def __init__(self, files: List[str], device="cpu"):
        self.device = device
        self.files = [SafetensorsFile(f) for f in files]
        self.index = {k: f for f in self.files for k in f.keys()}

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.index[name].get(name, self.device)

    def __iter__(self) -> Iterator[str]:
        return iter(self.index)

    def __len__(self) -> int:
        return len(self.index)

    def nbytes(self) -> int:
        return sum(e["data_offsets"][1] - e["data_offsets"][0]
                   for f in self.files for e in f.entries.values())

    def close(self) -> None:
        for f in self.files:
            f.close()


def load_safetensors_state(path: str, device="cpu",
                           exclude=()) -> SafetensorsState:
    """One ``.safetensors`` file, or every shard of a directory (less the
    names in ``exclude``), as a lazy :class:`SafetensorsState`."""
    return SafetensorsState(shard_files(path, exclude), device)


# -- writing -------------------------------------------------------------------

def _bytes_view(t: torch.Tensor) -> np.ndarray:
    t = t.detach().contiguous().cpu()
    if t.dtype == torch.bfloat16:
        t = t.view(torch.int16)
    elif t.dtype == torch.bool:
        t = t.view(torch.uint8)
    return t.numpy().reshape(-1).view(np.uint8)


def save_safetensors(tensors: Mapping[str, Any], path: str,
                     metadata: Optional[Dict[str, str]] = None) -> None:
    """Write ``{name: tensor or array}`` (any device) as one safetensors
    file.  The data is ordered by element size, then name, so every tensor
    starts aligned to its element; it is written one tensor at a time."""
    ts = {k: as_tensor(v) for k, v in tensors.items()}
    order = sorted(ts, key=lambda k: (-ts[k].element_size(), k))
    header: Dict[str, Any] = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    off = 0
    for k in order:
        t = ts[k]
        if t.dtype not in _NAMES:
            raise ValueError(f"{k}: dtype {t.dtype} has no safetensors name")
        n = t.numel() * t.element_size()
        header[k] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                     "data_offsets": [off, off + n]}
        off += n
    hb = json.dumps(header, separators=(",", ":")).encode()
    hb += b" " * (-len(hb) % 8)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(struct.pack("<Q", len(hb)))
        f.write(hb)
        for k in order:
            f.write(_bytes_view(ts[k]).data)
    os.replace(tmp, path)


# -- flat trees ----------------------------------------------------------------

def flatten_tree(tree: Any, prefix: str = "") -> Dict[str, Any]:
    out: Dict[str, Any] = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            assert SEP not in str(k), f"key {k!r} contains {SEP!r}"
            out.update(flatten_tree(v, f"{prefix}{k}{SEP}"))
    else:
        out[prefix[:-1]] = tree
    return out


def unflatten_tree(flat: Dict[str, Any]) -> Dict[str, Any]:
    root: Dict[str, Any] = {}
    for path, v in flat.items():
        parts = path.split(SEP)
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return root


def save_tree_safetensors(tree: Any, path: str) -> None:
    """A nested tree of tensors (or arrays) -> one file; bf16 leaves as U16
    named in the ``desta_dtypes`` metadata (the JAX package's format)."""
    arrays: Dict[str, torch.Tensor] = {}
    dtypes: Dict[str, str] = {}
    for k, v in flatten_tree(tree).items():
        t = as_tensor(v)
        if t.dtype == torch.bfloat16:
            dtypes[k] = "bfloat16"
            t = t.view(torch.uint16)
        arrays[k] = t
    save_safetensors(arrays, path,
                     metadata={"desta_dtypes": json.dumps(dtypes)})


def load_tree_safetensors(path: str, device="cpu") -> Dict[str, Any]:
    """A flat tree file -> nested dict of tensors on ``device``; leaves
    named bf16 in ``desta_dtypes`` come back as ``torch.bfloat16``."""
    f = SafetensorsFile(path)
    try:
        dtypes = json.loads(f.metadata.get("desta_dtypes", "{}"))
        flat = {}
        for k in f.keys():
            t = f.get(k, device)
            if dtypes.get(k) == "bfloat16":
                t = t.view(torch.bfloat16)
            flat[k] = t
    finally:
        f.close()
    return unflatten_tree(flat)
