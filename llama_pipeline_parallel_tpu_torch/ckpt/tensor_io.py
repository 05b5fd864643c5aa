"""Read and write the safetensors file layout without the safetensors package.

The layout: an 8-byte little-endian header length N, N bytes of JSON header
(padded with spaces to a multiple of 8), then the tensors' raw row-major
little-endian bytes back to back. The header maps each tensor's name to
`{"dtype", "shape", "data_offsets": [begin, end]}` (offsets counted from the
first byte after the header) and may hold `__metadata__`, a str -> str map.
Files written here open with `safetensors.{numpy,torch}.load_file`, and files
the package writes open here, for the dtypes in `DTYPES`.

Reads are lazy: `TensorFile` maps the file and hands out each tensor by name
as a view on the mapping, so a 7B file is never read whole into memory.
Writes go to a temporary file, are fsynced, then renamed over the target, all
under the shared storage retry policy (utils/retry.py): a crash never leaves
a torn file under the final name. A `Lazy` entry is made only when its bytes
are written, so a file of tensors assembled on demand holds one of them in
memory at a time.
"""

from __future__ import annotations

import dataclasses
import json
import math
import mmap
import os
import struct
import sys
from collections.abc import Callable, Iterator, Mapping
from typing import BinaryIO

import torch

from llama_pipeline_parallel_tpu_torch.utils import faults, retry

DTYPES = {"F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
          "I64": torch.int64, "I32": torch.int32}
_CODES = {dtype: code for code, dtype in DTYPES.items()}
INDEX_FILE = "model.safetensors.index.json"
SINGLE_FILE = "model.safetensors"

if sys.byteorder != "little":  # the layout is little-endian; tensors are written as they lie
    raise ImportError("tensor_io writes host memory as is: it needs a little-endian host")


@dataclasses.dataclass(frozen=True)
class Lazy:
    """A tensor for `write_file` that `make()` builds only when its bytes
    are written: its shape and dtype stand in for it in the header."""

    shape: tuple
    dtype: torch.dtype
    make: Callable[[], torch.Tensor]

    def numel(self) -> int:
        return math.prod(self.shape)

    def element_size(self) -> int:
        return self.dtype.itemsize


def _host_bytes(t: torch.Tensor | Lazy) -> memoryview:
    """The tensor's row-major bytes in host memory (a copy off the device)."""
    if isinstance(t, Lazy):
        t = t.make()
    flat = t.detach().to("cpu").contiguous().reshape(-1)
    return memoryview(flat.view(torch.uint8).numpy())


def write_atomic(path: str, fill: Callable[[BinaryIO], None]) -> None:
    """Crash-safe write: `fill` writes a temporary file, which is fsynced and
    renamed over `path`, under the storage retry policy. Readers see the old
    content or the new, never a torn file. Each try fires the `storage_write`
    fault site (utils/faults.py) with `path` as its tag."""

    def write() -> None:
        faults.fire("storage_write", tag=path)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "wb") as f:
                fill(f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    retry.retry_call(write, policy=retry.RetryPolicy.from_env(),
                     describe=f"write {os.path.basename(path)}")


def write_file(path: str, tensors: Mapping[str, torch.Tensor | Lazy],
               metadata: Mapping[str, str] | None = None) -> int:
    """Write `tensors` to `path` in the safetensors layout; returns the bytes
    written. Tensors may lie on any device: each is copied to host memory in
    turn, so a set on the card needs host memory for one tensor at a time.
    Wider dtypes come first (then names in order), so every tensor starts at
    a multiple of its element size, as the package lays them out."""
    names = sorted(tensors, key=lambda n: (-tensors[n].element_size(), n))
    header: dict = {}
    if metadata:
        header["__metadata__"] = {str(k): str(v) for k, v in metadata.items()}
    offset = 0
    for name in names:
        t = tensors[name]
        if t.dtype not in _CODES:
            raise ValueError(f"{name}: dtype {t.dtype} has no safetensors code here "
                             f"(supported: {sorted(DTYPES)})")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _CODES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode()
    raw += b" " * (-len(raw) % 8)

    def fill(f: BinaryIO) -> None:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for name in names:
            f.write(_host_bytes(tensors[name]))

    write_atomic(path, fill)
    return 8 + len(raw) + offset


class TensorFile:
    """One safetensors file, mapped: `keys()`, `metadata`, `shape(name)`,
    `dtype(name)` and `tensor(name)`, a CPU view on the mapping (copy it, or
    `copy_` it into a tensor on the card, before the file is replaced)."""

    def __init__(self, path: str):
        self.path = path
        with open(path, "rb") as f:
            head = f.read(8)
            if len(head) != 8:
                raise ValueError(f"{path}: too short for a safetensors header")
            (n,) = struct.unpack("<Q", head)
            size = os.fstat(f.fileno()).st_size
            if 8 + n > size:
                raise ValueError(f"{path}: header length {n} runs past the file ({size} bytes)")
            header = json.loads(f.read(n))
            # private (copy-on-write) mapping: writable, as torch.frombuffer
            # wants, and no page is read until a tensor is touched
            self._map = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
        self.metadata: dict[str, str] = header.pop("__metadata__", None) or {}
        self._start = 8 + n
        self._entries: dict[str, dict] = header
        for name, e in header.items():
            if e.get("dtype") not in DTYPES:
                raise ValueError(f"{path}: {name} has dtype {e.get('dtype')!r}; supported: "
                                 f"{sorted(DTYPES)}")
            begin, end = e["data_offsets"]
            want = DTYPES[e["dtype"]].itemsize
            for dim in e["shape"]:
                want *= dim
            if end - begin != want or self._start + end > size:
                raise ValueError(f"{path}: {name} data_offsets {e['data_offsets']} do not fit "
                                 f"shape {e['shape']} {e['dtype']} in {size} bytes")

    def keys(self) -> list[str]:
        return list(self._entries)

    def __getitem__(self, name: str) -> torch.Tensor:
        return self.tensor(name)

    def __contains__(self, name: str) -> bool:
        return name in self._entries

    def dtype(self, name: str) -> torch.dtype:
        return DTYPES[self._entries[name]["dtype"]]

    def shape(self, name: str) -> tuple[int, ...]:
        return tuple(self._entries[name]["shape"])

    def tensor(self, name: str) -> torch.Tensor:
        e = self._entries[name]
        dtype, shape = DTYPES[e["dtype"]], tuple(e["shape"])
        begin, end = (self._start + o for o in e["data_offsets"])
        if end == begin:
            return torch.empty(shape, dtype=dtype)
        if begin % dtype.itemsize:  # a writer that did not align: copy the bytes out
            return torch.frombuffer(bytearray(self._map[begin:end]), dtype=dtype).view(shape)
        return torch.frombuffer(self._map, dtype=dtype, count=(end - begin) // dtype.itemsize,
                                offset=begin).view(shape)

    def close(self) -> None:
        # the mapping closes when the last view on it is released
        self._map = None

    def __enter__(self) -> "TensorFile":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def load_file(path: str, device: str | torch.device = "cpu") -> dict[str, torch.Tensor]:
    """Every tensor of the file, copied onto `device`."""
    with TensorFile(path) as f:
        return {name: f.tensor(name).to(device, copy=True) for name in f.keys()}


class ShardedTensors(Mapping):
    """The tensors of an HF model directory by name, lazily: one
    `model.safetensors`, or the shards that `model.safetensors.index.json`'s
    `weight_map` names. Each lookup returns a CPU view on its shard's
    mapping."""

    def __init__(self, directory: str):
        index = os.path.join(directory, INDEX_FILE)
        if os.path.isfile(index):
            with open(index) as f:
                weight_map = json.load(f)["weight_map"]
        elif os.path.isfile(os.path.join(directory, SINGLE_FILE)):
            weight_map = None
        else:
            raise FileNotFoundError(f"no {SINGLE_FILE} or {INDEX_FILE} under {directory}")
        self._files: dict[str, TensorFile] = {}
        self._dir = directory
        if weight_map is None:
            single = self._open(SINGLE_FILE)
            weight_map = {name: SINGLE_FILE for name in single.keys()}
        self._where = weight_map

    def _open(self, filename: str) -> TensorFile:
        if filename not in self._files:
            self._files[filename] = TensorFile(os.path.join(self._dir, filename))
        return self._files[filename]

    def __getitem__(self, name: str) -> torch.Tensor:
        return self._open(self._where[name]).tensor(name)

    def __iter__(self) -> Iterator[str]:
        return iter(self._where)

    def __len__(self) -> int:
        return len(self._where)
