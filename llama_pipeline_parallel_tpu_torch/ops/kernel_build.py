"""Build the CUDA sources under `csrc/` with nvcc and load them with ctypes.

Each `csrc/<name>.cu` exposes a plain C interface and is compiled on its own
into `<build dir>/<name>-<hash>.so` for Hopper (`sm_90a`) the first time a
kernel of it is launched; the hash covers the source, the headers beside it
(`csrc/*.cuh`) and the flags, so an edited source is rebuilt and an
unchanged one is loaded as it is. A plain C
interface keeps PyTorch's headers out of the compile: a source builds in
seconds, not minutes.

The build directory is `build/torch_kernels/` beside the package (listed in
`.gitignore`), or `$LPT_TORCH_BUILD_DIR`. `build(names)` starts one nvcc per
source, all together, and waits for them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(_PKG_DIR, "csrc")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def build_dir() -> str:
    return os.environ.get("LPT_TORCH_BUILD_DIR") or os.path.join(
        os.path.dirname(_PKG_DIR), "build", "torch_kernels")


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found on PATH or at {path}; the CUDA "
                           f"kernels are built from source at first use")
    return path


def _target(name: str) -> tuple[str, str]:
    source = os.path.join(CSRC_DIR, f"{name}.cu")
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [source] + [os.path.join(CSRC_DIR, h) for h in headers]:
        with open(path, "rb") as f:
            digest.update(f.read())
    return source, os.path.join(build_dir(), f"{name}-{digest.hexdigest()[:16]}.so")


def library_path(name: str) -> str:
    """Where the library of `csrc/<name>.cu` is (or will be) built."""
    return _target(name)[1]


def build(names: list[str]) -> dict[str, str]:
    """Compile every named source that has no up-to-date library, one nvcc
    process each, started together. Returns {name: ptxas report} for the
    sources compiled by this call (register and spill counts per kernel)."""
    todo = [(name, *_target(name)) for name in names]
    todo = [t for t in todo if not os.path.exists(t[2])]
    if not todo:
        return {}
    os.makedirs(build_dir(), exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    for name, source, lib in todo:
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", tmp, source],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{output}")
            continue
        os.replace(tmp, lib)  # atomic: a concurrent process never loads half a file
        reports[name] = output
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return reports


def load(name: str) -> ctypes.CDLL:
    """The loaded library of `csrc/<name>.cu`, built first if needed."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build([name])
            lib = _LIBS[name] = ctypes.CDLL(_target(name)[1])
        return lib
