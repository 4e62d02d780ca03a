"""RDP accountant for the Poisson-subsampled Gaussian mechanism.

A copy of ``repro.core.accountant`` (numpy and scipy only), kept here so the
port never imports the JAX package; the tests hold the two equal.

Implements Mironov et al. 2019 ("Renyi Differential Privacy of the Sampled
Gaussian Mechanism") for integer orders, composition over steps, and the
improved RDP->(eps, delta) conversion used by Opacus/TF-Privacy.  Pure numpy —
this runs on the host, never inside jit.

The paper's engine (Appendix E) exposes ``target_epsilon`` -> ``sigma``; we
recover sigma by bisection on the accountant.
"""
from __future__ import annotations

import math
from typing import Sequence

import numpy as np
from scipy import special

DEFAULT_ALPHAS = tuple(range(2, 64)) + tuple(range(64, 513, 8))


def rdp_gaussian(sigma: float, alphas: Sequence[int]) -> np.ndarray:
    """RDP of the (unsubsampled) Gaussian mechanism: alpha / (2 sigma^2)."""
    a = np.asarray(alphas, dtype=np.float64)
    return a / (2.0 * sigma**2)


def rdp_subsampled_gaussian(
    q: float, sigma: float, alphas: Sequence[int]
) -> np.ndarray:
    """Per-step RDP at integer orders for Poisson sampling rate q.

    RDP(a) = 1/(a-1) * log sum_{k=0}^{a} C(a,k) (1-q)^{a-k} q^k e^{k(k-1)/2s^2}
    """
    if q == 0.0:
        return np.zeros(len(alphas))
    if q >= 1.0:
        return rdp_gaussian(sigma, alphas)
    out = []
    log_q = math.log(q)
    log_1q = math.log1p(-q)
    for a in alphas:
        a = int(a)
        ks = np.arange(a + 1, dtype=np.float64)
        log_terms = (
            special.gammaln(a + 1)
            - special.gammaln(ks + 1)
            - special.gammaln(a - ks + 1)
            + (a - ks) * log_1q
            + ks * log_q
            + ks * (ks - 1) / (2.0 * sigma**2)
        )
        out.append(special.logsumexp(log_terms) / (a - 1))
    return np.asarray(out)


def eps_from_rdp(
    rdp: np.ndarray, alphas: Sequence[int], delta: float
) -> tuple[float, int]:
    """Improved conversion (Balle et al. 2020): returns (eps, best_alpha)."""
    a = np.asarray(alphas, dtype=np.float64)
    eps = rdp + np.log((a - 1) / a) - (np.log(delta) + np.log(a)) / (a - 1)
    eps = np.where(eps < 0, np.inf, eps)
    i = int(np.argmin(eps))
    return float(eps[i]), int(a[i])


class RDPAccountant:
    """Tracks composed RDP over heterogeneous (q, sigma, steps) phases."""

    def __init__(self, alphas: Sequence[int] = DEFAULT_ALPHAS):
        self.alphas = tuple(alphas)
        self._rdp = np.zeros(len(self.alphas))

    def step(self, *, q: float, sigma: float, steps: int = 1) -> None:
        # compose one step at a time, not as `steps * rdp`: float addition is
        # not distributive over that multiply, and bit-exact resume (a crash
        # at step k replays `step(steps=k)` and must land on EXACTLY the
        # epsilon trajectory of the uninterrupted run) depends on replaying
        # the same additions in the same order
        r = rdp_subsampled_gaussian(q, sigma, self.alphas)
        for _ in range(steps):
            self._rdp = self._rdp + r

    def get_epsilon(self, delta: float) -> float:
        eps, _ = eps_from_rdp(self._rdp, self.alphas, delta)
        return eps


def compute_epsilon(
    *, q: float, sigma: float, steps: int, delta: float,
    alphas: Sequence[int] = DEFAULT_ALPHAS,
    release_sigmas: Sequence[float] = (),
) -> float:
    """Epsilon after ``steps`` compositions of the gradient mechanism plus
    any per-step side releases.

    ``release_sigmas`` are the noise multipliers of additional sensitivity-1
    queries the pipeline makes against the *same* Poisson-sampled batch each
    step — e.g. the quantile clipping policy's noised indicator count
    (``repro.policies.quantile``).  Each composes as its own subsampled
    Gaussian mechanism at rate ``q``; ignoring them would under-report the
    spend, so every epsilon the engine reports flows through here.
    """
    rdp = steps * rdp_subsampled_gaussian(q, sigma, alphas)
    for rs in release_sigmas:
        rdp = rdp + steps * rdp_subsampled_gaussian(q, rs, alphas)
    return eps_from_rdp(rdp, alphas, delta)[0]


def find_noise_multiplier(
    *, target_epsilon: float, q: float, steps: int, delta: float,
    sigma_min: float = 0.3, sigma_max: float = 1e4, tol: float = 1e-4,
    release_sigmas: Sequence[float] = (),
) -> float:
    """Smallest sigma achieving eps(sigma) <= target_epsilon (bisection).

    ``release_sigmas`` (fixed per-step side releases, e.g. the quantile
    policy's indicator) are composed inside the bisection, so the returned
    sigma lands the *total* spend on the target — no hand-tuned headroom.
    """

    def eps(s: float) -> float:
        return compute_epsilon(
            q=q, sigma=s, steps=steps, delta=delta,
            release_sigmas=release_sigmas,
        )

    if eps(sigma_max) > target_epsilon:
        raise ValueError(
            "target epsilon unreachable even at sigma_max"
            + (" (the per-step policy releases alone may exceed it)"
               if release_sigmas else "")
        )
    lo, hi = sigma_min, sigma_max
    if eps(lo) <= target_epsilon:
        return lo
    while hi / lo > 1 + tol:
        mid = math.sqrt(lo * hi)
        if eps(mid) <= target_epsilon:
            hi = mid
        else:
            lo = mid
    return hi
