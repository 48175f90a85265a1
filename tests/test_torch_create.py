"""The port's creation functions (tntorch_tpu_torch/create.py) against the
JAX package's, in float64 on the CPU: cores, factors and dense values
within 1e-14 (both build the same constants; NumPy's and JAX's grids and
the Gaussian bells' exponentials may differ in the last bit). ``rand_like``
and ``randn_like`` draw from another generator than JAX's: their shape,
device, dtype and ranks are held instead.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import tntorch_tpu as jtn
import tntorch_tpu_torch as tn

TOL = 1e-14


@pytest.fixture(autouse=True)
def _float64():
    prev = torch.get_default_dtype()
    torch.set_default_dtype(torch.float64)  # the JAX side runs float64
    yield
    torch.set_default_dtype(prev)


def _model():
    rng = np.random.default_rng(0)
    cores = [rng.standard_normal(s) for s in ((1, 3, 2), (2, 4, 2), (2, 5, 1))]
    return (tn.Tensor([torch.from_numpy(c) for c in cores]),
            jtn.Tensor([jnp.asarray(c) for c in cores]))


CASES = {
    "ones": lambda p: p.ones(3, 4, 5, **p.kw),
    "ones_tucker": lambda p: p.ones([3, 4, 5], ranks_tucker=[2, None, 3], **p.kw),
    "ones_batch": lambda p: p.ones(2, 3, 4, batch=True, **p.kw),
    "zeros": lambda p: p.zeros([3, 4], **p.kw),
    "full": lambda p: p.full([3, 4, 5], -2.5, **p.kw),
    "eye": lambda p: p.eye(4, **p.kw),
    "eye_rectangular": lambda p: p.eye(3, 5, **p.kw),
    "gaussian": lambda p: p.gaussian(5, 6, 1, **p.kw),
    "gaussian_sigmas": lambda p: p.gaussian([4, 7], sigma_factor=[0.1, 0.3], **p.kw),
    "arange": lambda p: p.arange(5, **p.kw),
    "arange_step": lambda p: p.arange(2, 9, 2, **p.kw),
    "linspace": lambda p: p.linspace(0, 1, 7, **p.kw),
    "linspace_open": lambda p: p.linspace(-1, 1, num=6, endpoint=False, **p.kw),
    "logspace": lambda p: p.logspace(0, 2, 5, **p.kw),
    "ones_like": lambda p: p.ones_like(p.model),
    "zeros_like": lambda p: p.zeros_like(p.model),
    "full_like": lambda p: p.full_like(p.model, 3.0),
    "gaussian_like": lambda p: p.gaussian_like(p.model),
}


class _Side:
    """One package's creation namespace, with its keywords for the CPU."""

    def __init__(self, package, model):
        self.package, self.model = package, model
        self.kw = dict(device="cpu") if package is tn else {}

    def __getattr__(self, name):
        return getattr(self.package, name)


@pytest.mark.parametrize("case", CASES)
def test_creation_matches_jax(case):
    model, jmodel = _model()
    make = CASES[case]
    got, want = make(_Side(tn, model)), make(_Side(jtn, jmodel))
    assert got.device.type == "cpu" and got.dtype == torch.float64
    assert got.batch == want.batch and tuple(got.shape) == tuple(want.shape)
    assert got.ranks_tt.tolist() == [int(r) for r in want.ranks_tt]
    for a, b in zip(got.cores + [U for U in got.Us if U is not None],
                    want.cores + [U for U in want.Us if U is not None]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=TOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(want.full()), rtol=0, atol=TOL)


def test_keywords_and_random_likes():
    model, _ = _model()
    t = tn.ones(3, 4, device="cpu", dtype=torch.float32, requires_grad=True)
    assert t.dtype == torch.float32 and t.requires_grad and t.cores[0].requires_grad
    assert tn.eye(3, device="cpu", requires_grad=True).cores[1].requires_grad
    assert tn.arange(4, device="cpu", dtype=torch.float32).dtype == torch.float32
    assert tn.gaussian(3, 4, device="cpu", dtype=torch.float32).Us[0].dtype == torch.float32
    for make in (tn.rand_like, tn.randn_like):
        r = make(model, ranks_tt=2)
        assert r.device == model.device and tuple(r.shape) == tuple(model.shape)
        assert r.ranks_tt.tolist() == [1, 2, 2, 1]
    assert float(tn.rand_like(model).full().min()) >= 0
    np.testing.assert_allclose(tn.gaussian(5, 6, device="cpu").numpy().sum(), 1.0, rtol=TOL)


def test_creation_without_a_device_goes_to_the_card():
    makers = (lambda: tn.ones(3, 4), lambda: tn.eye(3), lambda: tn.gaussian(3, 4),
              lambda: tn.arange(4), lambda: tn.full([3], 2.0))
    if torch.cuda.is_available():
        for make in makers:
            assert make().device.type == "cuda"
    else:  # no silent CPU fallback
        for make in makers:
            with pytest.raises((AssertionError, RuntimeError)):
                make()
