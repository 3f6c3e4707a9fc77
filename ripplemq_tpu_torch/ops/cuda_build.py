"""Build and load the port's CUDA kernels (nvcc → shared library → ctypes).

Each `csrc/<name>.cu` exposes a plain C interface and is compiled by
`nvcc` for `sm_90a` into `ops/_build/lib<name>-<hash>.so` at first use;
the hash covers the source and the flags, so an edited source rebuilds
and an unchanged one loads the cached library. The build directory is
listed in `.gitignore`.

There is no fallback: a missing `nvcc`, a failed build or a failed load
raises. Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
import time

CSRC_DIR = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parent / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOCK = threading.Lock()
_NAME_LOCKS: dict[str, threading.Lock] = {}  # one per kernel: builds overlap
_LIBS: dict[str, ctypes.CDLL] = {}
# name -> (seconds spent building, 0.0 when the cached library loaded;
#          the compiler's resource report)
BUILD_INFO: dict[str, tuple[float, str]] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin): the port's "
                       "CUDA kernels cannot be built on this host")


def load(name: str) -> ctypes.CDLL:
    """The compiled library for `csrc/<name>.cu`, built on first use.
    Different kernels may build at the same time from several threads."""
    with _LOCK:
        name_lock = _NAME_LOCKS.setdefault(name, threading.Lock())
    with name_lock:
        lib = _LIBS.get(name)
        if lib is not None:
            return lib
        src = CSRC_DIR / f"{name}.cu"
        digest = hashlib.sha256(
            src.read_bytes() + " ".join(NVCC_FLAGS).encode()
        ).hexdigest()[:16]
        so = BUILD_DIR / f"lib{name}-{digest}.so"
        report = so.with_suffix(".log")
        t0 = time.perf_counter()
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            proc = subprocess.run(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
                capture_output=True, text=True, timeout=600,
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed to build {src.name} "
                    f"(exit {proc.returncode}):\n{proc.stderr}")
            report.write_text(proc.stdout + proc.stderr)
            os.replace(tmp, so)
            built_s = time.perf_counter() - t0
        else:
            built_s = 0.0
        lib = ctypes.CDLL(str(so))
        BUILD_INFO[name] = (built_s,
                            report.read_text() if report.exists() else "")
        _LIBS[name] = lib
        return lib
