"""Build and bind the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library, loaded with ``ctypes``. The
libraries are built at first use, all sources in parallel (one ``nvcc`` process
each), into ``build/`` beside ``src/``, under a
file name keyed by a hash of the sources and flags, so a source edit rebuilds
and an unchanged tree reuses. Nothing here runs when the module is imported:
a machine without ``nvcc`` can import the package and use the plain versions
on CPU tensors.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
KERNELS = ("topk_merge", "sweep_merge", "frontier_relax")
HEADERS = ("kround.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_libs: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    return Path(__file__).resolve().parents[3] / "build"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are compiled at first "
        "use and need the CUDA toolkit (PATH, $CUDA_HOME or /usr/local/cuda)"
    )


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu", *HEADERS):
        h.update((CSRC / src).read_bytes())
    return build_dir() / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(*, verbose: bool = False) -> float:
    """Compile every kernel library that is missing; returns the seconds spent.

    All missing libraries are compiled at once, one ``nvcc`` each. With
    ``verbose`` the compiler also reports each kernel's registers and shared
    memory (``-Xptxas -v``) on standard error.
    """
    t0 = time.perf_counter()
    todo = [(name, _lib_path(name)) for name in KERNELS]
    todo = [(name, path) for name, path in todo if not path.exists()]
    if todo:
        nvcc = _nvcc()
        build_dir().mkdir(parents=True, exist_ok=True)
        procs = []
        for name, path in todo:
            tmp = path.with_suffix(f".tmp{os.getpid()}.so")
            cmd = [nvcc, *NVCC_FLAGS, *(("-Xptxas", "-v") if verbose else ()),
                   "-I", str(CSRC), "-o", str(tmp), str(CSRC / f"{name}.cu")]
            procs.append((name, path, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
        failed = []
        for name, path, tmp, proc in procs:
            out, err = proc.communicate()
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{out}\n{err}")
                continue
            if verbose:
                print(err, file=sys.stderr)
            os.replace(tmp, path)
        if failed:
            raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (builds all kernels at first use)."""
    lib = _libs.get(name)
    if lib is None:
        path = _lib_path(name)
        if not path.exists():
            build_all()
        lib = _libs[name] = ctypes.CDLL(str(path))
    return lib
