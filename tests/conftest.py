# NOTE: deliberately NO XLA_FLAGS device-count override here — smoke tests
# and benches must see the real single CPU device.  Multi-device tests
# (sharding/elastic) spawn subprocesses that set their own XLA_FLAGS.
import os

import numpy as np
import pytest

import jax

# Runtime strictness for the whole suite: implicit rank promotion
# ((3,) + (4, 3) silently broadcasting) is exactly the kind of shape bug
# the correlator's (B, O, H, W, T) tensors make easy to write and hard
# to see — make it a hard error everywhere tests touch.
jax.config.update("jax_numpy_rank_promotion", "raise")

# Opt-in NaN debugging: REPRO_DEBUG_NANS=1 re-runs any jitted computation
# that produced a NaN in op-by-op mode and raises at the culprit.  Not the
# default — it disables async dispatch and some tests (chaos/quarantine)
# produce NaNs on purpose.
if os.environ.get("REPRO_DEBUG_NANS") == "1":
    jax.config.update("jax_debug_nans", True)


@pytest.fixture
def rng():
    return np.random.RandomState(0)


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skips on a host without one")
