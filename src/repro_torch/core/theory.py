"""Theorem 4.1 (SEMULATOR): the emulator's training-acceptance bound (the
port of ``repro.core.theory``).

To guarantee ``P(|Y - f(X)| < 0.5 * 10^-s) > p`` for a regression network
whose error is ~ N(0, sigma^2) (Lemma 4.2), the MSE must satisfy

    E[|Y - f(X)|^2] = sigma^2  <  0.5 * (10^-s / erfinv(p))^2

``mse_bound`` follows the paper's numeric example (s=3, p=0.3 -> 6.7e-6),
which carries 10^-s through erf; ``mse_bound_strict`` uses the Theorem
statement's 0.5 * 10^-s.  Both are evaluated in float32, as the reference
evaluates them.
"""
from __future__ import annotations

import math

import torch

# Giles' single-precision erfinv polynomial ("Approximating the erfinv
# function", GPU Computing Gems, 2011), as XLA evaluates it for float32:
# coefficients for w = -log1p(-x^2) below 5 and at or above it
_ERFINV_LT5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
               -4.39150654e-06, 0.00021858087, -0.00125372503,
               -0.00417768164, 0.246640727, 1.50140941)
_ERFINV_GE5 = (-0.000200214257, 0.000100950558, 0.00134934322,
               -0.00367342844, 0.00573950773, -0.0076224613,
               0.00943887047, 1.00167406, 2.83297682)


def erfinv_f32(x: torch.Tensor) -> torch.Tensor:
    """float32 erfinv on the reference's polynomial.

    ``torch.special.erfinv`` is one ulp away from the reference's value at
    p = 0.3, which moves ``mse_bound(3, 0.3)`` by 2e-7 relative; this
    evaluation matches it there.  For |x| < 1 only."""
    x = x.float()
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, torch.sqrt(w) - 3.0)

    def coef(i):
        return torch.where(lt, torch.tensor(_ERFINV_LT5[i], device=x.device),
                           torch.tensor(_ERFINV_GE5[i], device=x.device))

    p = coef(0)
    for i in range(1, len(_ERFINV_LT5)):
        p = coef(i) + p * w
    return p * x


def _bound(numer: float, p: float) -> float:
    e = erfinv_f32(torch.tensor(p, dtype=torch.float32))
    return float(0.5 * (torch.tensor(numer, dtype=torch.float32) / e) ** 2)


def mse_bound(s: int, p: float) -> float:
    """Upper bound on MSE (paper's numeric convention; s=3, p=0.3 -> 6.73e-6)."""
    return _bound(10.0 ** (-s), p)


def mse_bound_strict(s: int, p: float) -> float:
    """Same bound with the Theorem statement's 0.5 * 10^-s inside erf."""
    return _bound(0.5 * 10.0 ** (-s), p)


def significance_probability(errors: torch.Tensor, s: int) -> torch.Tensor:
    """Empirical P(|err| < 0.5 * 10^-s)."""
    return torch.mean((torch.abs(errors) < 0.5 * 10.0 ** (-s)).float())


def check_significance(errors: torch.Tensor, s: int, p: float) -> bool:
    """Does the empirical error distribution satisfy the Thm 4.1 condition?"""
    return bool(significance_probability(errors, s) > p)


def predicted_probability(mse: float, s: int) -> float:
    """Given an achieved MSE (= sigma^2 under Lemma 4.2), the probability
    P(|err| < 10^-s) predicted by the Gaussian model: erf(10^-s / sqrt(2 mse))."""
    return math.erf(10.0 ** (-s) / math.sqrt(2.0 * max(mse, 1e-30)))
