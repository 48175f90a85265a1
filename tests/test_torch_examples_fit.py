"""The port's training tutorials (tntorch_tpu_torch/examples/, the last
five of ``examples.NAMES``) on the CPU in float64, under
``expected.CPU_CAPS``'s iteration caps: their figures that depend on no
draw (degrees of freedom, the LARS surrogate, the sparse TT-SVD's ranks,
the multichip tutorial's ranks, shapes and placements) against the JAX
tutorials', and their claims and fitted figures against the capped
thresholds of ``expected.check``. The multichip tutorial spawns its 8
gloo ranks. The card runs them uncapped (chip_smoke.py phases 15 and 16).
"""

import importlib

import pytest
import torch

from tntorch_tpu_torch.examples import NAMES, expected


@pytest.fixture(autouse=True)
def _one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # six test workers share the cores
    yield
    torch.set_num_threads(threads)


@pytest.mark.parametrize("name", NAMES[8:])
def test_training_tutorial_meets_its_claims(name):
    module = importlib.import_module(f"tntorch_tpu_torch.examples.{name}")
    out = module.main(device="cpu", dtype=torch.float64, **expected.CPU_CAPS[name])
    failed = expected.check(name, out, torch.float64, capped=True)
    assert not failed, failed
