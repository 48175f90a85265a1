"""Test harness configuration.

- Runs on a *virtual 8-device CPU mesh* (``xla_force_host_platform_device_count``)
  so multi-chip sharding paths execute without TPU hardware, as the driver does.
- Enables float64 (``jax_enable_x64``) to match the reference test suite's
  ``torch.set_default_dtype(torch.float64)`` oracle tolerance (1e-7..1e-9).
"""

import os
import tempfile

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

# Persistent compilation cache shared by all xdist workers (and across
# runs): the suite's wall time is dominated by XLA compiles of the many
# random-rank program shapes, and every worker otherwise recompiles the
# same programs. min_entry_size -1 + min_compile_time 0 admit the small
# CPU executables that the defaults would skip.
jax.config.update(
    "jax_compilation_cache_dir",
    os.environ.get("TNT_TEST_CACHE", os.path.join(tempfile.gettempdir(), "tnt_test_xla_cache")),
)
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)

# Atomic cache writes BEFORE any compilation: a run killed mid-write (or two
# processes racing on one key) otherwise leaves a truncated entry whose
# deserialization segfaults the next suite run warm-starting from the shared
# cache (see utils._patch_atomic_cache_writes).
from tntorch_tpu.utils import _patch_atomic_cache_writes  # noqa: E402

_patch_atomic_cache_writes()


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips without one (run: python -m pytest -m cuda)"
    )
