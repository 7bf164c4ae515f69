"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each source under vistracker_tpu_torch/csrc/ is compiled on first use into
a shared library with a plain C interface (no PyTorch headers, so a build
takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -o build/kernels/lib<name>_<hash>.so csrc/<name>.cu

The library lands in build/kernels/ at the root of the checkout; its name
carries a hash of the source, the shared headers (csrc/*.cuh) and the
flags, so an edited source is rebuilt. `build_all` starts one nvcc per
source at once.

Host code (csrc/<name>.cpp, e.g. the JPEG codec of data/imageio.py) is
built the same way with g++ by `load_host_library`:

    g++ -O3 -shared -fPIC -std=c++17 -o build/kernels/lib<name>_<hash>.so \
        csrc/<name>.cpp
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH); "
                       "the CUDA kernels are built from csrc/ at first use")


def _lib_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    for header in sorted(CSRC.glob("*.cuh")):
        src += header.read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:12]}.so"


def build_all(names) -> dict:
    """Compile csrc/<name>.cu for every name whose library is missing, all
    nvcc processes started together; returns {name: nvcc log} (ptxas
    register and shared-memory lines), "" for one already built."""
    logs, running = {}, []
    for name in names:
        out = _lib_path(name)
        if out.is_file():
            logs[name] = ""
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        running.append((name, out, tmp, subprocess.Popen(
            [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in running:
        logs[name] = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed for csrc/{name}.cu:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build(name: str) -> str:
    """Compile csrc/<name>.cu unless its library exists; returns the nvcc
    log, "" if already built."""
    return build_all([name])[name]


@functools.cache
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu as a ctypes library."""
    build(name)
    return ctypes.CDLL(str(_lib_path(name)))


_HOST_BUILD = threading.Lock()  # loader threads may ask at once


@functools.cache
def load_host_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the host C++ source csrc/<name>.cpp with
    g++ as a ctypes library."""
    src = (CSRC / f"{name}.cpp").read_bytes()
    digest = hashlib.sha256(src + " ".join(GXX_FLAGS).encode()).hexdigest()
    out = BUILD_DIR / f"lib{name}_{digest[:12]}.so"
    with _HOST_BUILD:
        if not out.is_file():
            _gxx(name, out)
    return ctypes.CDLL(str(out))


def _gxx(name: str, out: Path):
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError(f"no C++ compiler (g++) to build csrc/{name}.cpp")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    res = subprocess.run([cxx, *GXX_FLAGS, "-o", str(tmp),
                          str(CSRC / f"{name}.cpp")],
                         capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"g++ failed for csrc/{name}.cpp:\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, out)
