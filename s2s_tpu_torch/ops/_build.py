"""Build the port's CUDA sources with ``nvcc`` and load them with ``ctypes``.

Every ``csrc/*.cu`` file is compiled for ``sm_90a`` by its own ``nvcc``
process, all started together, and the objects are linked into ONE shared
library with a plain C interface (no PyTorch headers, so a build takes
seconds, not minutes).  The library lands in ``build/s2s_tpu_torch/`` at the repository
root, named by a hash of the sources and flags, so an edited source is never
served from a stale build.  Nothing happens at import: the first kernel call
(or an explicit :func:`load`) builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "s2s_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the s2s_tpu_torch CUDA kernels "
        "are built from s2s_tpu_torch/csrc/ at first use and need the CUDA toolkit"
    )


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _library_path() -> Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"libs2s_tpu_torch_{digest.hexdigest()[:16]}.so"


def build() -> tuple[Path, str]:
    """Compile ``csrc/*.cu`` unless an up-to-date library exists.  Returns
    (library path, compiler output)."""
    global build_seconds
    lib_path = _library_path()
    if lib_path.exists():
        build_seconds = 0.0
        return lib_path, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib_path.with_suffix(f".{os.getpid()}.tmp")
    nvcc = _nvcc()
    t0 = time.perf_counter()
    objs = [tmp.with_name(f"{tmp.name}.{src.stem}.o") for src in _sources()]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)] for src, obj in zip(_sources(), objs)]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    logs = [proc.communicate()[0] for proc in procs]
    cmds.append([nvcc, *NVCC_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)])
    failed = [(cmd, proc.returncode, log) for cmd, proc, log in zip(cmds, procs, logs) if proc.returncode]
    if not failed:
        link = subprocess.run(cmds[-1], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        if link.returncode:
            failed = [(cmds[-1], link.returncode, link.stdout)]
    for obj in objs:
        obj.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(
            f"(exit {rc}) {' '.join(cmd)}\n{log}" for cmd, rc, log in failed))
    os.replace(tmp, lib_path)
    build_seconds = time.perf_counter() - t0
    return lib_path, "".join(logs)


def load() -> ctypes.CDLL:
    """The built kernel library with its C signatures declared (built on
    first call, then cached for the process)."""
    global _lib
    with _lock:
        if _lib is None:
            path, _ = build()
            lib = ctypes.CDLL(str(path))
            ptr, i32 = ctypes.c_void_p, ctypes.c_int
            lib.s2s_int8_matmul.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, i32, ptr]
            lib.s2s_int8_matmul.restype = i32
            lib.s2s_decode_attention.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                                 i32, i32, i32, i32, i32, i32, i32,
                                                 ctypes.c_float, ptr]
            lib.s2s_decode_attention.restype = i32
            _lib = lib
        return _lib


def count_launch(wrapper) -> None:
    """Add one to ``wrapper.launches``, the count a kernel's wrapper keeps of
    its launches.  Locked: the driver threads of several engines launch
    concurrently."""
    with _count_lock:
        wrapper.launches += 1
