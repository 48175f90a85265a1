"""The port's host maxvol library (tntorch_tpu_torch/csrc/maxvol_host.cpp,
loaded by tntorch_tpu_torch/_native.py) against the JAX package's
(csrc/maxvol.cpp, tntorch_tpu/_native), on the same NumPy inputs in float64
and float32.

Both libraries are the same algorithms with the same order of operations,
built by the same host compiler with the same flags on the same machine,
so rows, K and C are bitwise equal; so are the host `maxvol` and
`rect_maxvol` of both packages, which reach the libraries where the JAX
package's do (the counters and a spy on the JAX loader show where). A
build that fails raises: no NumPy answer stands in for it."""

import ast
import importlib
import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn
from tntorch_tpu_torch import _build

JN = importlib.import_module("tntorch_tpu._native")
TN = importlib.import_module("tntorch_tpu_torch._native")
TM = importlib.import_module("tntorch_tpu_torch.maxvol")
DTYPES = [np.float64, np.float32]


def _matrix(shape, dtype, seed=0):
    """A tall matrix with columns of unequal scale (the LU start is not yet
    maximal, so the swap loop has work), or a rank-deficient orthonormal
    basis: 12 orthonormal columns mixed into 20."""
    rng = np.random.default_rng(seed)
    if shape == "rank_deficient":
        Q = np.linalg.qr(rng.standard_normal((300, 12)))[0]
        return (Q @ rng.standard_normal((12, 20))).astype(dtype)
    n, r = shape
    return (rng.standard_normal((n, r)) * np.geomspace(1, 1e3, r)).astype(dtype)


SHAPES = [(40, 5), (300, 20), (2000, 64), "rank_deficient"]
IDS = ["40x5", "300x20", "2000x64", "rank_deficient"]


def _equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1].dtype == want[1].dtype and got[1].shape == want[1].shape
    np.testing.assert_array_equal(got[1], want[1])


@pytest.fixture(scope="module", autouse=True)
def _jax_library_loaded():
    assert JN.get_lib() is not None  # the JAX package's library is compared, not NumPy


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("shape", SHAPES, ids=IDS)
def test_entry_points_match_jax_library(shape, dtype):
    A = _matrix(shape, dtype)
    r = A.shape[1]
    _equal(TN.native_maxvol(A, 1.05, 100), JN.native_maxvol(A, 1.05, 100))
    for maxK, minK in ((None, None), (r + 7, r + 3)):
        _equal(TN.native_rect_maxvol(A, 1.0, maxK, minK, 10, True),
               JN.native_rect_maxvol(A, 1.0, maxK, minK, 10, True))
    _equal(TN.native_rect_maxvol(A, 1.5, None, None, 10, False),
           JN.native_rect_maxvol(A, 1.5, None, None, 10, False))
    # the swap loop alone, from the LU start's C = A inv(A[rows])
    rows = TM._initial_pivots(A, A.shape[0])[:r].copy()
    C = np.ascontiguousarray(A @ np.linalg.inv(A[rows]))
    mine, theirs = (rows.copy(), C.copy()), (rows.copy(), C.copy())
    got = TN.native_maxvol_iterate(mine[1], mine[0], 1.05, 100)
    assert JN.native_maxvol_iterate(theirs[1], theirs[0], 1.05, 100)
    _equal((got, mine[1]), theirs)
    np.testing.assert_array_equal(mine[0], rows)  # swapped in a copy
    for bad in (np.asfortranarray(C), C[:, :-1], C.astype(np.float16)):
        with pytest.raises(ValueError, match="C-contiguous"):
            TN.native_maxvol_iterate(bad, rows, 1.05, 100)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
def test_an_exactly_singular_start_is_refused_as_in_jax(dtype):
    rng = np.random.default_rng(1)
    A = np.hstack([np.linalg.qr(rng.standard_normal((300, 12)))[0],
                   np.zeros((300, 8))]).astype(dtype)
    assert TN.native_maxvol(A, 1.05, 100) is None and JN.native_maxvol(A, 1.05, 100) is None
    assert TN.native_rect_maxvol(A, 1.0, None, None, 10, True) is None
    assert JN.native_rect_maxvol(A, 1.0, None, None, 10, True) is None
    for fn, jfn in ((tn.maxvol, jtn.maxvol), (tn.rect_maxvol, jtn.rect_maxvol)):
        with pytest.raises(np.linalg.LinAlgError):
            jfn(A)
        with pytest.raises(np.linalg.LinAlgError):
            fn(A)


@pytest.mark.parametrize("dtype", DTYPES, ids=["float64", "float32"])
@pytest.mark.parametrize("shape", [(300, 20), (2000, 64)], ids=["300x20", "2000x64"])
def test_host_maxvol_and_rect_maxvol_match_jax_bitwise(shape, dtype):
    A = _matrix(shape, dtype, seed=2)
    n, r = A.shape
    _equal(tn.maxvol(A), jtn.maxvol(A))
    _equal(tn.maxvol(A, 1.01, 5), jtn.maxvol(A, 1.01, 5))
    init = np.random.default_rng(3).choice(n, r, replace=False).astype(np.int64)
    mine, theirs = init.copy(), init.copy()
    _equal(tn.maxvol(A, init_rows=mine), jtn.maxvol(A, init_rows=theirs))
    np.testing.assert_array_equal(mine, init)  # never written
    _equal(tn.rect_maxvol(A, maxK=r), jtn.rect_maxvol(A, maxK=r))
    _equal(tn.rect_maxvol(A), jtn.rect_maxvol(A))


@pytest.fixture
def jax_spy(monkeypatch):
    """Counts of the JAX package's native entry points, by the names the
    port's counter uses."""
    counts = dict.fromkeys(TN.calls, 0)
    for name in counts:
        real = getattr(JN, f"native_{name}")

        def spy(*args, _real=real, _name=name):
            counts[_name] += 1
            return _real(*args)

        monkeypatch.setattr(JN, f"native_{name}", spy)
    return counts


def _complex(A):
    return A + 1j * np.roll(A, 1, axis=0)


# (call, its arguments): where the JAX package takes its library and where
# it runs NumPy
CALLS = {
    "maxvol": ("maxvol", lambda A: (A,), {}),
    "maxvol_warm": ("maxvol", lambda A: (A,), dict(init_rows=np.arange(3, 15))),
    "maxvol_float32": ("maxvol", lambda A: (A.astype(np.float32),), {}),
    "maxvol_top_k_index": ("maxvol", lambda A: (A,), dict(top_k_index=50)),
    "maxvol_complex": ("maxvol", lambda A: (_complex(A),), {}),
    "rect_maxvol": ("rect_maxvol", lambda A: (A,), {}),
    "rect_maxvol_maxK": ("rect_maxvol", lambda A: (A,), dict(maxK=12)),
    "rect_maxvol_top_k_index": ("rect_maxvol", lambda A: (A,), dict(top_k_index=60)),
    "rect_maxvol_min_add_K": ("rect_maxvol", lambda A: (A,), dict(min_add_K=3)),
    "rect_maxvol_complex": ("rect_maxvol", lambda A: (_complex(A),), {}),
}


@pytest.mark.parametrize("case", CALLS, ids=list(CALLS))
def test_counters_show_the_library_where_jax_takes_its_own(case, jax_spy):
    name, args, kw = CALLS[case]
    A = _matrix((200, 12), np.float64, seed=4)
    TN.reset_calls()
    got = getattr(tn, name)(*args(A), **{k: np.copy(v) for k, v in kw.items()})
    want = getattr(jtn, name)(*args(A), **{k: np.copy(v) for k, v in kw.items()})
    np.testing.assert_array_equal(got[0], want[0])
    assert np.abs(got[1] - want[1]).max() <= 1e-12 * max(np.abs(want[1]).max(), 1.0)
    assert TN.calls == jax_spy
    library = sum(TN.calls.values())
    if case.endswith(("_top_k_index", "_complex")):
        assert library == 0
    elif case == "rect_maxvol_min_add_K":
        # min_add_K grows the rows in NumPy, from maxvol's square rows, which
        # take the swap loop as the JAX package's do
        assert TN.calls == {"maxvol": 0, "maxvol_iterate": 1, "rect_maxvol": 0}
    else:
        assert library == 1


def test_the_plain_versions_never_reach_the_library():
    A = _matrix((200, 12), np.float64, seed=4)
    TN.reset_calls()
    rows, C = TM._maxvol_plain(A)
    krows, KC = TM._rect_maxvol_plain(A, maxK=15)
    assert sum(TN.calls.values()) == 0
    np.testing.assert_array_equal(rows, tn.maxvol(A)[0])
    np.testing.assert_array_equal(krows, tn.rect_maxvol(A, maxK=15)[0])
    assert np.abs(KC - tn.rect_maxvol(A, maxK=15)[1]).max() <= 1e-12 * np.abs(KC).max()


@pytest.fixture
def build_dir(tmp_path, monkeypatch):
    """Builds go to ``tmp_path``, and the loaded libraries are forgotten
    before and after."""
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    _build.library.cache_clear()
    yield tmp_path
    _build.library.cache_clear()


def test_a_missing_compiler_raises_and_never_falls_back(build_dir, monkeypatch):
    missing = str(build_dir / "no-such-g++")
    monkeypatch.setattr(_build, "CXX", missing)
    A = _matrix((200, 12), np.float64)
    for call in (lambda: tn.maxvol(A), lambda: tn.rect_maxvol(A), lambda: tn.py_maxvol(A)):
        with pytest.raises(RuntimeError, match="no-such-g"):
            call()
    assert list(build_dir.iterdir()) == []


def test_a_failed_build_raises_with_the_compilers_output(build_dir, monkeypatch):
    broken = build_dir / "maxvol_host.cpp"
    broken.write_text('extern "C" int tnt_maxvol( { return 0; }\n')
    monkeypatch.setitem(_build.HOST_SOURCES, "maxvol_host", broken)
    with pytest.raises(RuntimeError, match=r"(?s)g\+\+ failed on maxvol_host\.cpp:\n.*error"):
        tn.maxvol(_matrix((200, 12), np.float64))
    assert not list(build_dir.glob("*.so")) and not list(build_dir.glob("*.tmp"))


def test_the_library_is_keyed_on_source_flags_and_machine(build_dir, monkeypatch):
    assert _build.CXX == "g++"
    flags = _build.CXX_FLAGS
    assert flags == ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17"]
    path = _build.library_path("maxvol_host")
    assert path.parent == build_dir and path.name.startswith("maxvol_host_")
    monkeypatch.setattr(_build, "CXX_FLAGS", [*flags, "-g"])
    assert _build.library_path("maxvol_host") != path
    monkeypatch.setattr(_build, "CXX_FLAGS", flags)
    assert _build.library_path("maxvol_host") == path
    monkeypatch.setattr(_build, "_host_target", lambda cxx, flags: "another machine")
    assert _build.library_path("maxvol_host") != path


_CONCURRENT = """
import importlib.util, sys
spec = importlib.util.spec_from_file_location("b", sys.argv[1])
b = importlib.util.module_from_spec(spec)
spec.loader.exec_module(b)
b.BUILD_DIR = b.Path(sys.argv[2])
lib = b.library("maxvol_host")
print(b.library_path("maxvol_host").name, lib.tnt_maxvol is not None)
"""


def test_concurrent_builds_each_load_the_one_library(tmp_path):
    # three processes build into one empty directory at once, as test
    # workers do at first use: each compiles into files of its own and
    # moves them into place
    src = Path(_build.__file__)
    procs = [subprocess.Popen([sys.executable, "-c", _CONCURRENT, str(src), str(tmp_path)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(3)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    assert len({o for o, _ in outs}) == 1 and outs[0][0].split()[1] == "True"
    names = sorted(p.name for p in tmp_path.iterdir())
    stem = outs[0][0].split()[0][:-3]
    assert names == [f"{stem}.log", f"{stem}.so"]


def test_native_module_imports_nothing_of_the_jax_package():
    path = Path(TN.__file__)
    for node in ast.walk(ast.parse(path.read_text())):
        names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                 else [node.module or ""] if isinstance(node, ast.ImportFrom) else [])
        for name in names:
            assert not (name == "jax" or name.startswith(("jax.", "tntorch_tpu.")))
            assert name != "tntorch_tpu"
    code = ("import sys, tntorch_tpu_torch._native as n, tntorch_tpu_torch.maxvol; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tntorch_tpu')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=Path(_build.__file__).parents[1])
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr
