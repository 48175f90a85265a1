"""Build and load the package's CUDA kernels (``csrc/*.cu``) at first use.

``nvcc`` compiles each source into its own shared library with a plain C
interface, which ``ctypes`` loads: no PyTorch headers, so a build takes
seconds. A library lands in ``tntorch_tpu_torch/_build/`` under a name keyed
on a hash of its source, so an edited source is rebuilt and a stale library
is never loaded. `build_all` starts one ``nvcc`` per source at once. Nothing
is fetched and nothing prebuilt ships; without ``nvcc`` the build raises.
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
SOURCES = {p.stem: p for p in sorted((_HERE / "csrc").glob("*.cu"))}
BUILD_DIR = _HERE / "_build"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

# The C entry points of each library and their argument types
SIGNATURES = {
    "gram_kernels": {
        "tnt_gram_edge": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "tnt_wgram": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "tnt_proj2": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "tnt_proj2_resident": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "tnt_gram_resident": [_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "tnt_occupancy": [_I, _I, _I],
    },
    "tt_eval": {
        "tnt_tt_eval": [_I, _I, _I, _PP, _PI, _PI, _P, _L, _P, _P, _P],
        "tnt_tt_eval_backward": [_I, _I, _I, _PP, _PP, _PI, _PI, _P, _P, _L, _P, _P],
        "tnt_tt_eval_grouped": [_I, _P, _I, _I, _I, _P, _P, _L, _P, _P, _P, _P, _P, _I, _P, _P],
        "tnt_tt_eval_slice_grad": [_I, _I, _I, _I, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _I,
                                   _P, _L, _L, _L, _P, _P],
    },
}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    found = shutil.which("nvcc")
    if found is None and CUDA_HOME is not None:
        candidate = Path(CUDA_HOME) / "bin" / "nvcc"
        found = str(candidate) if candidate.exists() else None
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA toolkit is needed to build the kernels")
    return found


def library_path(name: str) -> Path:
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def build_all(names=None) -> dict:
    """Compile each named source (default: all) whose library does not exist
    yet, one ``nvcc`` per source, all started together; returns the library
    paths by name. The compiler's output (``-Xptxas -v``: registers, shared
    memory, spills) is kept beside each library as ``.log``."""
    names = list(SOURCES) if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = {name: so for name, so in paths.items() if not so.exists()}
    if todo:
        BUILD_DIR.mkdir(exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for name, so in todo.items():
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            procs[name] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for name, (tmp, proc) in procs.items():
            log = proc.communicate()[0]
            todo[name].with_suffix(".log").write_text(log)
            if proc.returncode != 0:
                failed.append(f"nvcc failed on {SOURCES[name].name}:\n{log}")
            else:
                os.replace(tmp, todo[name])  # atomic: a concurrent loader never sees half a file
        if failed:
            raise RuntimeError("\n".join(failed))
    return paths


def build(name: str) -> Path:
    """Compile one source unless its library exists; returns the library path."""
    return build_all([name])[name]


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first call."""
    lib = ctypes.CDLL(str(build(name)))
    for fn, argtypes in SIGNATURES[name].items():
        getattr(lib, fn).argtypes = argtypes
        getattr(lib, fn).restype = ctypes.c_int
    return lib
