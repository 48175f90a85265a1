"""Build and load the package's compiled code at first use: the CUDA kernels
(``csrc/*.cu``) and the host maxvol library (``csrc/*.cpp``).

``nvcc`` compiles each CUDA source into its own shared library with a plain
C interface, which ``ctypes`` loads: no PyTorch headers, so a build takes
seconds. The host C++ compiler (`CXX`, with the JAX package's native build
flags `CXX_FLAGS`: ``-O3 -march=native -fPIC -shared -std=c++17``) builds
each host source the same way. A library lands in
``tntorch_tpu_torch/_build/`` under a name keyed on a hash of its source, so
an edited source is rebuilt and a stale library is never loaded; a host
library's key also covers the compiler, its flags and the machine
``-march=native`` compiles for, whose code another machine may not run.
`build_all` starts one compiler per source at once. Nothing is fetched and
nothing prebuilt ships; without the compiler, or when it fails, the build
raises a `RuntimeError` that names it and carries its output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_HERE = Path(__file__).resolve().parent
SOURCES = {p.stem: p for p in sorted((_HERE / "csrc").glob("*.cu"))}
HOST_SOURCES = {p.stem: p for p in sorted((_HERE / "csrc").glob("*.cpp"))}
BUILD_DIR = _HERE / "_build"
# The host compiler and the JAX package's flags for its native library
# (tntorch_tpu/_native): the same code, so the same roundoff
CXX = "g++"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
# --split-compile=0: nvcc optimizes a source's kernels on all the host's
# cores at once (the tt_eval source holds 188 instances; its build times
# with and without it are in PERF.md)
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0",
]

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_D = ctypes.c_double
_LONG = ctypes.c_long
_PP = ctypes.POINTER(ctypes.c_void_p)
_PI = ctypes.POINTER(ctypes.c_int)

# Seconds each source's compiler took in this process's builds, by source
BUILD_SECONDS = {}

# The C entry points of each library and their argument types
SIGNATURES = {
    "gram_kernels": {
        "tnt_gram_edge": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "tnt_wgram": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "tnt_proj2": [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "tnt_proj2_tile": [_I, _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        "tnt_gram_tile": [_I, _I, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "tnt_occupancy": [_I, _I],
        "tnt_tile_occupancy": [_I, _I, _I, _I, _I],
    },
    "tt_eval": {
        "tnt_tt_eval": [_I, _I, _I, _PP, _PI, _PI, _P, _P, _L, _P, _P, _I, _I, _I, _I, _P],
        "tnt_tt_eval_backward": [_I, _I, _I, _PP, _PP, _PI, _PI, _P, _P, _P, _L, _P, _I, _I, _PI,
                                 _I, _P, _L, _P],
        "tnt_tt_eval_grouped": [_I, _P, _I, _I, _I, _P, _P, _L, _P, _P, _P, _P, _P, _I, _P, _P],
        "tnt_tt_eval_slice_grad": [_I, _I, _I, _I, _P, _P, _P, _P, _L, _I, _P, _P, _P, _P, _I,
                                   _P, _L, _L, _L, _P, _P],
    },
    "maxvol_device": {
        "tnt_lu_rows": [_P, _I, _I, _I, _I, _P, _P],
        "tnt_maxvol_swaps": [_I, _I, _P, _P, _I, _I, _I, _D, _I, _I, _P, _P, _P],
    },
    "maxvol_host": {
        "tnt_maxvol": [_P, _LONG, _LONG, _D, _LONG, _P, _P],
        "tnt_maxvol_f32": [_P, _LONG, _LONG, _D, _LONG, _P, _P],
        "tnt_maxvol_iterate": [_P, _LONG, _LONG, _D, _LONG, _P],
        "tnt_maxvol_iterate_f32": [_P, _LONG, _LONG, _D, _LONG, _P],
        "tnt_rect_maxvol": [_P, _LONG, _LONG, _D, _LONG, _LONG, _LONG, _LONG, _P, _P, _P],
        "tnt_rect_maxvol_f32": [_P, _LONG, _LONG, _D, _LONG, _LONG, _LONG, _LONG, _P, _P, _P],
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


@functools.lru_cache(maxsize=None)
def _host_target(cxx: str, flags: tuple) -> str:
    """The compiler's version and the target it compiles for under
    ``flags`` (for ``-march=native``: this machine's architecture and its
    instruction sets), as the compiler prints them."""
    out = []
    for args in (["-dumpfullversion"], [*flags, "-Q", "--help=target"]):
        try:
            proc = subprocess.run([cxx, *args], capture_output=True, text=True, timeout=60)
        except OSError as exc:
            raise RuntimeError(f"the host C++ compiler {cxx!r} cannot run: {exc}") from exc
        if proc.returncode != 0:
            raise RuntimeError(f"the host C++ compiler {cxx!r} failed on {' '.join(args)}:\n"
                               f"{proc.stdout}{proc.stderr}")
        out.append(proc.stdout)
    return "".join(out)


def library_path(name: str) -> Path:
    if name in HOST_SOURCES:
        key = hashlib.sha256(HOST_SOURCES[name].read_bytes())
        key.update("\0".join([CXX, *CXX_FLAGS, _host_target(CXX, tuple(CXX_FLAGS))]).encode())
        return BUILD_DIR / f"{name}_{key.hexdigest()[:16]}.so"
    digest = hashlib.sha256(SOURCES[name].read_bytes()).hexdigest()[:16]
    return BUILD_DIR / f"{name}_{digest}.so"


def _command(name: str, out: Path) -> list:
    """The compiler's command line that builds source ``name`` into ``out``."""
    if name in HOST_SOURCES:
        return [CXX, *CXX_FLAGS, "-o", str(out), str(HOST_SOURCES[name])]
    return [_nvcc(), *NVCC_FLAGS, "-o", str(out), str(SOURCES[name])]


def build_all(names=None) -> dict:
    """Compile each named source (default: all, CUDA and host) whose library
    does not exist yet, one compiler per source, all started together;
    returns the library paths by name. The compiler's output (for ``nvcc``,
    ``-Xptxas -v``: registers, shared memory, spills) is kept beside each
    library as ``.log``, and each source's compile time in
    `BUILD_SECONDS`. Several processes may build at once: each compiles into
    files of its own and moves them into place."""
    names = [*SOURCES, *HOST_SOURCES] if names is None else list(names)
    paths = {name: library_path(name) for name in names}
    todo = {name: so for name, so in paths.items() if not so.exists()}
    if todo:
        BUILD_DIR.mkdir(exist_ok=True)
        tmps = {name: so.with_name(f"{so.name}.{os.getpid()}.tmp") for name, so in todo.items()}
        cmds = {name: _command(name, tmp) for name, tmp in tmps.items()}  # raises first
        procs = {}
        start = time.time()
        for name, so in todo.items():
            tmp, cmd = tmps[name], cmds[name]
            log = so.with_name(f"{so.stem}.{os.getpid()}.log.tmp")
            with open(log, "w") as out:
                try:
                    proc = subprocess.Popen(cmd, stdout=out, stderr=subprocess.STDOUT, text=True)
                except OSError as exc:
                    raise RuntimeError(f"the compiler {cmd[0]!r} cannot run: {exc}") from exc
            procs[name] = (tmp, log, cmd[0], proc)
        seconds = {}
        while len(seconds) < len(procs):
            for name, (*_, proc) in procs.items():
                if name not in seconds and proc.poll() is not None:
                    seconds[name] = time.time() - start
            time.sleep(0.05)
        BUILD_SECONDS.update(seconds)
        failed = []
        for name, (tmp, log, compiler, proc) in procs.items():
            text = log.read_text()
            os.replace(log, todo[name].with_suffix(".log"))
            if proc.returncode != 0:
                source = (HOST_SOURCES.get(name) or SOURCES[name]).name
                failed.append(f"{compiler} failed on {source}:\n{text}")
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
