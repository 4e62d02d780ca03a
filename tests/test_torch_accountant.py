"""The port's RDP accountant equals the JAX package's (to 1e-12)."""
import math

import pytest

from repro.core import accountant as jacc
from repro_torch.core import accountant as tacc
from torch_threads import torch_threads_per_worker  # noqa: F401

CASES = [
    dict(q=256 / 50_000, sigma=1.1, steps=1000, delta=1e-5),
    dict(q=0.01, sigma=0.8, steps=50, delta=1e-6),
    dict(q=1.0, sigma=2.0, steps=3, delta=1e-5),
]


def _close(a: float, b: float) -> None:
    assert math.isclose(a, b, rel_tol=1e-12, abs_tol=1e-12), (a, b)


@pytest.mark.parametrize("case", CASES)
def test_compute_epsilon_matches_jax(case):
    _close(tacc.compute_epsilon(**case), jacc.compute_epsilon(**case))
    rel = dict(case, release_sigmas=(5.0,))
    _close(tacc.compute_epsilon(**rel), jacc.compute_epsilon(**rel))


@pytest.mark.parametrize("target", [1.0, 3.0, 8.0])
def test_find_noise_multiplier_matches_jax(target):
    kw = dict(target_epsilon=target, q=256 / 50_000, steps=500, delta=1e-5)
    _close(tacc.find_noise_multiplier(**kw), jacc.find_noise_multiplier(**kw))


def test_accountant_step_replay_matches_jax():
    """Step-by-step composition over mixed phases, as a resume replays it."""
    t, j = tacc.RDPAccountant(), jacc.RDPAccountant()
    for q, sigma, steps in [(0.01, 1.0, 5), (0.02, 0.7, 3), (0.01, 1.0, 4)]:
        t.step(q=q, sigma=sigma, steps=steps)
        j.step(q=q, sigma=sigma, steps=steps)
        _close(t.get_epsilon(1e-5), j.get_epsilon(1e-5))
