"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source into a shared library with a plain C
interface, which ``ctypes`` loads: no PyTorch headers, so a build takes
seconds. The library lands in ``tntorch_tpu_torch/_build/`` under a name
keyed on a hash of the source, so an edited source is rebuilt and a stale
library is never loaded. Nothing is fetched and nothing prebuilt ships;
without ``nvcc`` the build raises.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCE = _HERE / "csrc" / "gram_kernels.cu"
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(candidate) if candidate.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{SOURCE.stem}_{digest}.so"


def build() -> Path:
    """Compile the source unless its library exists; returns the library path.
    The compiler's output (``-Xptxas -v``: registers, shared memory, spills)
    is kept beside the library as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    proc = subprocess.run(
        [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True,
    )
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {SOURCE.name}:\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader never sees half a file
    return so


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    lib = ctypes.CDLL(str(build()))
    lib.tnt_gram_edge.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.tnt_wgram.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
    lib.tnt_proj2.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
    lib.tnt_occupancy.argtypes = [_I, _I]
    for fn in (lib.tnt_gram_edge, lib.tnt_wgram, lib.tnt_proj2, lib.tnt_occupancy):
        fn.restype = ctypes.c_int
    return lib
