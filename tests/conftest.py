import os

# Smoke tests and benches must see the single real CPU device (the dry-run
# sets its own 512-device flag inside launch/dryrun.py only).
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import pytest  # noqa: E402

jax.config.update("jax_enable_x64", False)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA device (the port's hand-written kernels); skips elsewhere"
    )


@pytest.fixture(autouse=True)
def _reset_obs_sinks():
    # the obs sink registry is process-wide; a test that configures a run
    # (directly or via launch.train main) must not leak sinks into the next
    from repro.obs import events, sinks

    yield
    sinks.reset_sinks()
    events.set_run_context(None)
