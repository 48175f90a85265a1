"""The port's slice as a whole: build a TT from numpy cores, do arithmetic,
round it, measure it, through tntorch_tpu_torch's public API and through
tntorch_tpu's, on the same inputs. Dense reconstructions are compared, never
cores (a rounded TT is defined up to a gauge). f64 throughout: the two
packages differ by roundoff, so values agree to 1e-10 relative."""

import inspect
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tntorch_tpu as jtn
# imported on first use otherwise, and dir(jtn) must not depend on the tests before
import tntorch_tpu.cross_host  # noqa: F401
import tntorch_tpu_torch as tn
import torch_parallel_ranks as ranks
from tntorch_tpu_torch import interop
from tntorch_tpu_torch.ops import rounding as tr

TOL = 1e-10
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    torch.set_num_threads(1)  # six test workers share the cores


def _cores(seed, batch, ranks=(3, 4, 3), shape=(6, 7, 8, 9)):
    rng = np.random.default_rng(seed)
    ranks = [1, *ranks, 1]
    b = (batch,) if batch else ()
    return [rng.standard_normal(b + (ranks[n], s, ranks[n + 1])) for n, s in enumerate(shape)]


def _pair(seed, batch, **kw):
    """The same TT in both packages."""
    cores = _cores(seed, batch, **kw)
    return interop.tensor_from_arrays(cores, batch=bool(batch), device="cpu"), jtn.Tensor(
        [jnp.asarray(c) for c in cores], batch=bool(batch))


def _close(got, want, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    assert np.linalg.norm(got - want) <= tol * np.linalg.norm(want)


def _jax_sketch(n, r, dtype, device):
    key = jax.random.fold_in(jax.random.fold_in(jax.random.key(7), n), r)
    return torch.from_numpy(np.array(jax.random.normal(key, (n, r), dtype=jnp.float64))).to(
        device=device, dtype=dtype)


BATCH = pytest.mark.parametrize("batch", [0, 3], ids=["single", "batch3"])


@BATCH
def test_arithmetic_matches_jax(batch):
    a, ja = _pair(1, batch)
    b, jb = _pair(2, batch)
    for got, want in [
        (a + 0.01 * b, ja + 0.01 * jb),
        (a - b, ja - jb),
        (-a, -ja),
        (a * b, ja * jb),
        (2.5 * a + 1.0, 2.5 * ja + 1.0),
        (3.0 - a, 3.0 - ja),
        (a / 4.0, ja / 4.0),
    ]:
        assert got.ranks_tt.tolist() == want.ranks_tt.tolist()
        _close(got.full().numpy(), want.full())


@BATCH
def test_equality_matches_jax(batch):
    # == is dist <= 1e-14 on every sample (a Python bool); a Tensor is unhashable
    a, ja = _pair(21, batch)
    b, jb = _pair(22, batch)
    for got, want in [(a == a.clone(), ja == ja.clone()), (a != a.clone(), ja != ja.clone()),
                      (a == b, ja == jb), (a != b, ja != jb), (a == a.full(), ja == ja.full())]:
        assert got is want
    assert (a == a.clone(), a == b) == (True, False)
    for t in (a, ja):
        with pytest.raises(TypeError, match="unhashable"):
            hash(t)


@pytest.mark.parametrize("op", ["mul", "div"])
def test_torch_scalar_with_grad_matches_jax(op):
    # A 0-d torch scalar that requires grad stays in the graph: t * s and
    # t / s match dense (and the JAX package) to 1e-12 in f64, and the
    # gradient of sum((t op s).full()) reaches s
    a, ja = _pair(23, 0)
    s = torch.tensor(-2.5, dtype=torch.float64, requires_grad=True)
    got = a * s if op == "mul" else a / s
    want = ja * -2.5 if op == "mul" else ja / -2.5
    dense = a.full().detach().numpy()
    _close(got.full().detach().numpy(), dense * (-2.5 if op == "mul" else 1 / -2.5), tol=1e-12)
    _close(got.full().detach().numpy(), want.full(), tol=1e-12)
    assert got.dtype == torch.float64
    got.full().sum().backward()
    ds = dense.sum() * (1.0 if op == "mul" else -1 / 2.5 ** 2)
    assert abs(float(s.grad) - ds) <= 1e-12 * abs(ds)


@pytest.mark.parametrize("dtypes", [(np.float32, np.float64), (np.float64, np.float32)],
                         ids=["f32+f64", "f64+f32"])
def test_mixed_dtype_sum_keeps_left_dtype_as_jax(dtypes):
    (a, _), (b, _) = _pair(24, 0), _pair(25, 0)
    cores = [[c.numpy().astype(d) for c in t.cores] for t, d in zip((a, b), dtypes)]
    got = (interop.tensor_from_arrays(cores[0], device="cpu")
           + interop.tensor_from_arrays(cores[1], device="cpu"))
    want = jtn.Tensor([jnp.asarray(c) for c in cores[0]]) + jtn.Tensor(
        [jnp.asarray(c) for c in cores[1]])
    assert [str(c.dtype).split(".")[-1] for c in got.cores] == [str(c.dtype) for c in want.cores]
    assert got.dtype == torch.from_numpy(np.zeros(1, dtypes[0])).dtype
    _close(got.full().double().numpy(), np.asarray(want.full(), np.float64), tol=1e-6)


def test_constructor_signature_matches_jax():
    names = list(inspect.signature(tn.Tensor.__init__).parameters)
    assert names == list(inspect.signature(jtn.Tensor.__init__).parameters)
    x = np.ones((2, 3))
    t = tn.Tensor(x, None, None, "cpu", None, max_iter=3, tol=1e-2, verbose=True,
                  algorithm="svd")
    assert t.device.type == "cpu" and t.requires_grad is False
    idxs = [np.arange(2) + 4, np.arange(3)]  # an annotation, as in the JAX package
    t, jt = tn.Tensor(x, idxs=idxs, device="cpu"), jtn.Tensor(x, idxs=idxs)
    assert [i.tolist() for i in t.idxs] == [i.tolist() for i in jt.idxs]


@pytest.mark.cuda
def test_division_by_a_norm_on_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    a, ja = _pair(26, 0)
    t = interop.tensor_from_arrays([c.numpy() for c in a.cores], device="cuda")
    u = t / t.norm()
    assert u.device.type == "cuda" and u.dtype == torch.float64
    _close(u.full().cpu().numpy(), (ja / jtn.norm(ja)).full(), tol=1e-12)


def test_per_sample_scalars_match_jax():
    a, ja = _pair(3, 2)
    s = np.array([1.5, -2.0])
    _close((a * s).full().numpy(), (ja * jnp.asarray(s)).full())
    _close((a + s).full().numpy(), (ja + jnp.asarray(s)).full())


def test_broadcast_by_repeat_matches_jax():
    a, ja = _pair(4, 0, shape=(2, 3, 4), ranks=(2, 2))
    b, jb = _pair(5, 0, shape=(4, 3, 8), ranks=(2, 2))
    _close((a + b).full().numpy(), (ja + jb).full())
    _close((a * b).full().numpy(), (ja * jb).full())


@BATCH
@pytest.mark.parametrize("algorithm", ["gram", "randgram"])
def test_round_tt_gram_matches_jax(batch, algorithm, monkeypatch):
    # randgram draws JAX's own sketch here (see test_torch_rounding for the
    # port's own); its power iterations amplify roundoff: 1e-8
    monkeypatch.setattr(tr, "_sketch", _jax_sketch)
    a, ja = _pair(6, batch, ranks=(5, 6, 5))
    b, jb = _pair(7, batch, ranks=(5, 6, 5))
    t, jt = a + 0.01 * b, ja + 0.01 * jb
    t.round_tt(rmax=4, algorithm=algorithm)
    jt.round_tt(rmax=4, algorithm=algorithm)
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist() == [1, 4, 4, 4, 1]
    _close(t.full().numpy(), jt.full(), tol=TOL if algorithm == "gram" else 1e-8)


@BATCH
@pytest.mark.parametrize("algorithm", ["svd", "eig"])
def test_round_tt_eps_matches_jax(batch, algorithm):
    # t + t has exactly redundant directions: both packages drop them. A
    # batch has no error budget (rank min(rmax, rows, cols), so roundoff
    # directions stay): rmax caps it at the true ranks
    a, ja = _pair(8, batch)
    t, jt = a + a, ja + ja
    rmax = [3, 4, 3] if batch else None
    t.round_tt(1e-10, rmax=rmax, algorithm=algorithm)
    jt.round_tt(1e-10, rmax=rmax, algorithm=algorithm)
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist() == [1, 3, 4, 3, 1]
    _close(t.full().numpy(), jt.full())


@BATCH
def test_round_tt_verbose_branch_matches_jax(batch):
    a, ja = _pair(9, batch)
    t, jt = a + a, ja + ja
    t.round_tt(1e-10, rmax=3, verbose=True)
    jt.round_tt(1e-10, rmax=3, verbose=True)
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
    _close(t.full().numpy(), jt.full())


def test_f32_gram_under_highest_routes_to_svd():
    cores = [c.astype(np.float32) for c in _cores(10, 0, ranks=(5, 6, 5))]
    t = interop.tensor_from_arrays(cores, device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores])
    t.round_tt(rmax=3, algorithm="gram")
    jt.round_tt(rmax=3, algorithm="gram")
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
    _close(t.full().numpy(), jt.full(), tol=1e-5)  # f32 SVD sweeps


@BATCH
def test_metrics_match_jax(batch):
    a, ja = _pair(11, batch)
    b, jb = _pair(12, batch)
    for got, want in [
        (tn.dot(a, b), jtn.dot(ja, jb)),
        (a.dot(b), ja.dot(jb)),
        (tn.norm(a), jtn.norm(ja)),
        (a.normsq(), ja.normsq()),
        (tn.dist(a, b), jtn.dist(ja, jb)),
        (tn.relative_error(a, a + 0.01 * b), jtn.relative_error(ja, ja + 0.01 * jb)),
        (tn.relative_error(a.full(), b), jtn.relative_error(ja.full(), jb)),
    ]:
        _close(got.numpy(), want)


def test_partial_dot_matches_jax():
    a, ja = _pair(13, 0)
    b, jb = _pair(14, 0, shape=(6, 7), ranks=(2,))
    _close(tn.dot(a, b).full().numpy(), jtn.dot(ja, jb).full())
    _close(tn.dot(b, a).full().numpy(), jtn.dot(jb, ja).full())


def test_complex_norm_matches_jax():
    rng = np.random.default_rng(15)
    cores = [rng.standard_normal(s) + 1j * rng.standard_normal(s)
             for s in [(1, 4, 2), (2, 5, 2), (2, 6, 1)]]
    t = interop.tensor_from_arrays(cores, device="cpu")
    jt = jtn.Tensor([jnp.asarray(c) for c in cores])
    _close(tn.norm(t).numpy(), jtn.norm(jt))
    _close(tn.dist(t, 2 * t).numpy(), jtn.dist(jt, 2 * jt))


@BATCH
def test_dense_construction_and_orthogonalize_match_jax(batch):
    rng = np.random.default_rng(16)
    x = rng.standard_normal(((batch,) if batch else ()) + (3, 4, 5))
    t = tn.Tensor(torch.from_numpy(x), batch=bool(batch))
    jt = jtn.Tensor(jnp.asarray(x), batch=bool(batch))
    assert t.ranks_tt.tolist() == jt.ranks_tt.tolist()
    _close(t.full().numpy(), x)
    t.orthogonalize(1)
    jt.orthogonalize(1)
    _close(t.full().numpy(), jt.full())
    Q = t.cores[0].reshape(((batch,) if batch else ()) + (-1, t.cores[0].shape[-1]))
    eye = torch.eye(Q.shape[-1], dtype=Q.dtype)
    assert torch.allclose(Q.mT @ Q, eye.expand(Q.shape[:-2] + eye.shape), atol=1e-12)


@BATCH
def test_shape_ranks_and_repr_match_jax(batch):
    a, ja = _pair(17, batch)
    assert a.shape == tuple(ja.shape)
    assert a.dim() == ja.dim()
    assert a.ranks_tt.tolist() == ja.ranks_tt.tolist()
    assert repr(a) == repr(ja)


def test_interop_round_trip_and_device():
    cores = _cores(18, 2)
    t = interop.tensor_from_arrays(cores, batch=True, device="cpu")
    back = interop.tensor_to_arrays(t)
    assert all(np.array_equal(x, y) and x.dtype == y.dtype for x, y in zip(back, cores))
    jt = jtn.Tensor([jnp.asarray(c) for c in cores], batch=True)
    t2 = interop.tensor_from_arrays(jt.cores, batch=True, device="cpu")  # JAX arrays cross too
    _close(t2.full().numpy(), jt.full())


def test_functional_round_tt_leaves_input():
    a, _ = _pair(19, 0)
    t = a + a
    r = tn.round_tt(t, eps=1e-10)
    assert t.ranks_tt.tolist() == [1, 6, 8, 6, 1]
    assert r.ranks_tt.tolist() == [1, 3, 4, 3, 1]


# The JAX package's public API that the slices have ported: every public
# name of ``dir(tntorch_tpu)``
PORTED = {
    "Tensor", "asarray", "autodiff", "create", "cross", "default_dtype", "dist", "dof", "dot",
    "get_policy", "init_interfaces", "matmul_precision", "maxvol", "mean", "meshgrid",
    "metrics", "next_key", "norm", "normsq", "ops", "optimize", "parallel", "py_maxvol",
    "py_rect_maxvol", "r_squared", "rand", "randn", "rect_maxvol", "relative_error", "rmse",
    "round", "round_tt", "round_tt_fixed", "round_tt_gram", "round_tucker", "set_policy",
    "squeeze", "stack", "std", "sum", "tensor", "tools", "truncated_svd", "tt_dot", "tt_eval",
    "tt_full", "ttm", "unsqueeze", "utils", "var",
    # the minimizing cross and the cross replay (tests/test_torch_minimize.py)
    "cross_forward", "minimum", "maximum", "argmin", "argmax",
    # the elementwise family (tests/test_torch_ops.py)
    "abs", "acos", "add", "asin", "atan", "atan2", "cos", "cosh", "cumprod", "cumsum", "div",
    "erf", "erfinv", "exp", "log", "log10", "log2", "mul", "pow", "reciprocal", "rsqrt",
    "sigmoid", "sin", "sinh", "sqrt", "tan", "tanh",
    # moments (tests/test_torch_ops.py, tests/test_torch_moments.py)
    "skew", "kurtosis", "hadamard_sum", "raw_moment", "normalized_moment",
    # creation (tests/test_torch_create.py)
    "ones", "ones_like", "zeros", "zeros_like", "full", "full_like", "eye", "gaussian",
    "gaussian_like", "rand_like", "randn_like", "arange", "linspace", "logspace",
    # the tools (tests/test_torch_tools.py)
    "cat", "transpose", "flip", "unbind", "unfolding", "right_unfolding", "left_unfolding",
    "mask", "sample", "hash", "generate_basis", "reduce", "pad", "convolve", "shift_mode",
    # completion, interpolation and learning (tests/test_torch_interpolation.py,
    # tests/test_torch_learners.py)
    "als_completion", "sparse_tt_svd", "get_bounding_box", "features2indices",
    "indices2features", "empirical_marginals", "gram_schmidt", "lars_path", "PCEInterpolator",
    "TTRegressor", "TTClassifier", "interpolation", "models",
    # CP tensors and the analytics (tests/test_torch_{cp,anova,logic,derivatives,matrix}.py)
    "anova", "anova_decomposition", "undo_anova_decomposition", "truncate_anova", "sobol",
    "mean_dimension", "dimension_distribution", "logic", "true", "false", "all", "none",
    "any", "one", "symbols", "relevant_symbols", "irrelevant_symbols", "only", "presence",
    "absence", "is_tautology", "is_contradiction", "is_satisfiable", "implies", "equiv",
    "automata", "weight_mask", "weight_one_hot", "weight", "length", "accepted_inputs",
    "derivatives", "partialset", "partial", "gradient", "active_subspace", "dgsm",
    "divergence", "curl", "laplacian", "matrix", "TTMatrix", "CPMatrix", "tt_multiply",
    "cp_multiply",
    # serialization and the host sweep (tests/test_torch_{serialization,cross_host}.py)
    "serialization", "save", "load", "save_matrix", "load_matrix", "cross_host",
    # the checkpoints on torch.distributed.checkpoint (tests/test_torch_serialization.py,
    # tests/test_torch_parallel_paths.py)
    "save_orbax", "load_orbax", "save_orbax_sharded", "load_orbax_sharded",
}


def _jax_api():
    """The public names of ``tntorch_tpu`` that are its own: not the names
    that its star imports leak (typing, jax, numpy, time, the package)."""
    for name in dir(jtn):
        obj = getattr(jtn, name)
        module = isinstance(obj, types.ModuleType)
        where = obj.__name__ if module else getattr(obj, "__module__", "")
        if not name.startswith("_") and obj is not jtn and str(where).startswith("tntorch_tpu"):
            yield name


def test_entry_points_outside_the_slice_raise(tmp_path):
    a, _ = _pair(20, 0)
    api = set(_jax_api())
    # every name is ported: none is left to raise
    assert PORTED == api
    for name in sorted(api):
        assert hasattr(tn, name), name
    for name in (n for n in dir(jtn.Tensor) if not n.startswith("_")):
        assert hasattr(tn.Tensor, name), name

    # what raised here until the mesh= paths and the checkpoints were ported
    # now runs; their positive tests are in tests/test_torch_parallel_paths.py
    # (4 ranks) and tests/test_torch_serialization.py. On one rank the mesh
    # changes no value.
    domain = [np.arange(4.0)] * 3
    kw = dict(function=lambda *x: sum(x), domain=domain, device="cpu", verbose=False, seed=0)
    with ranks.solo_mesh() as mesh:
        for extra in ({}, dict(fuse="host")):
            got = tn.cross(mesh=mesh, **kw, **extra).numpy()
            assert np.array_equal(got, tn.cross(**kw, **extra).numpy())
    tn.save_orbax(a, tmp_path / "orbax")
    assert np.array_equal(tn.load_orbax(tmp_path / "orbax", device="cpu").numpy(), a.numpy())

    def setitem():
        a[0, 0, 0, 0] = 1.0

    # what this list held until assignment, serialization, the bf16 Gram
    # variant and the host sweep were ported now runs; each has its positive
    # test in tests/test_torch_{setitem,serialization,bf16,cross_host}.py
    def bf16():
        tn.set_policy("bf16")
        try:
            tn.round_tt(tn.Tensor([c[None] for c in a.cores], batch=True), rmax=2,
                        algorithm="gram")
        finally:
            tn.set_policy("highest")

    for call in (setitem, bf16,
                 lambda: tn.cross(function=lambda *x: sum(x), domain=domain, device="cpu",
                                  verbose=False, fuse="host"),
                 lambda: tn.save(a, tmp_path / "a.npz"),
                 lambda: tn.load(tmp_path / "a.npz", device="cpu")):
        call()
    # what this list held until CP tensors and the analytics were ported now
    # runs; each has its positive test in tests/test_torch_{cp,anova,logic,matrix}.py
    x = tn.symbols(4, device="cpu", dtype=a.dtype)[0]
    for call in (lambda: tn.randn(3, 3, ranks_cp=2, device="cpu"),
                 lambda: tn.sobol(a, tn.only(x)), lambda: tn.anova.sobol(a, tn.only(x)),
                 lambda: tn.Tensor(torch.ones((3, 3), dtype=a.dtype), ranks_cp=2),
                 lambda: tn.Tensor([np.ones((3, 2)), np.ones((3, 2))], device="cpu"),
                 lambda: a[tn.all(4, device="cpu", dtype=a.dtype)],
                 lambda: tn.models.TTMatrix(torch.eye(4, dtype=a.dtype), [2], [2, 2], [2, 2])):
        call()
    # what this list held until the minimizing cross, the elementwise family,
    # creation, the moments and the tools were ported now runs; each has its
    # positive test in tests/test_torch_{minimize,ops,create,moments,tools}.py
    for call in (lambda: tn.tools.transpose(a), lambda: tn.cat([a, a], dim=0),
                 lambda: a.clone().set_factors("legendre"), lambda: tn.dot(a, a, k=1),
                 lambda: tn.minimum(a, verbose=False), lambda: tn.exp(a),
                 lambda: tn.ones(3, 3, device="cpu"), lambda: tn.skew(a),
                 lambda: tn.hadamard_sum([a, a]), lambda: a ** 2, lambda: 2.0 ** a,
                 lambda: 2.0 / (a * a + 1), lambda: (a * a + 1) / (a * a + 1),
                 lambda: tn.cross(function=lambda *x: sum(x), domain=domain, device="cpu",
                                  verbose=False, record_samples=True),
                 lambda: tn.cross(function=lambda *x: sum(x), domain=domain, device="cpu",
                                  verbose=False, _minimize=True)):
        call()
    # with cross ported, a call without a domain or tensors fails as the
    # JAX package's does
    for package in (tn, jtn):
        with pytest.raises(AssertionError):
            package.cross()


def test_as_leaf_detaches_in_place_as_jax():
    a, ja = _pair(21, 0)
    t = tn.Tensor([c.clone().requires_grad_() for c in a.cores])
    assert t.as_leaf() is t and ja.as_leaf() is ja
    assert not any(c.requires_grad for c in t.cores)
    _close(t.numpy(), ja.numpy())


def test_policy_pins_full_float32_matmuls():
    prev = torch.get_float32_matmul_precision()
    torch.set_float32_matmul_precision("high")
    try:
        seen = []
        tn.utils.policy_precision(lambda: seen.append(torch.get_float32_matmul_precision()))()
        assert seen == ["highest"]
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.set_float32_matmul_precision(prev)
    tn.set_policy("high")
    try:
        assert tn.get_policy() == "high"
        assert tr.resolve_edge_solver(None, tn.utils.resolve_precision()) == "rand"
    finally:
        tn.set_policy("highest")
    with pytest.raises(ValueError):
        tn.set_policy("tf32")


def test_package_never_imports_jax():
    # nor the JAX package, not even its modules without JAX (maxvol.py); the
    # tutorials (tntorch_tpu_torch/examples/) and the parallel layer's
    # modules (loaded on use) included, nor optax
    code = ("import importlib, sys, tntorch_tpu_torch, tntorch_tpu_torch.examples as ex; "
            "[importlib.import_module(f'tntorch_tpu_torch.examples.{n}') "
            "for n in ex.NAMES + ('expected',)]; "
            "[importlib.import_module(f'tntorch_tpu_torch.parallel.{n}') "
            "for n in ('launch', 'mesh', 'algorithms')]; "
            "bad = [m for m in sys.modules if m in ('jax', 'optax', 'tntorch_tpu') "
            "or m.startswith(('jax.', 'jaxlib', 'optax.', 'tntorch_tpu.'))]; "
            "assert not bad, bad")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
