"""Compound aggregates built from Sum/Count (counterpart of
`spark_tpu/expr/agg_compound.py`).

corr, covar_pop, covar_samp, skewness and kurtosis: instead of bespoke
multi-column buffers, each function expands into an expression over
single-input Sums of computed terms (sum x, sum y, sum xy, sum x^2, x^3,
x^4) and counts, the reference's raw-moment formulas, so the aggregation
operator reduces them with its ordinary sum and count buffers in one pass.
Null semantics: the pairwise functions count only rows where both
arguments are non-null (guarded terms).
"""

from __future__ import annotations

from .expressions import (
    And, Cast, Count, Divide, Expression, GreaterThan, If, IsNotNull, Literal,
    Multiply, Sqrt, Subtract, Sum, cast_if,
)
from ..types import float64


def _f(e: Expression) -> Expression:
    return cast_if(e, float64)


def _guard2(x: Expression, y: Expression, term: Expression) -> Expression:
    """term when both x and y are non-null, else NULL (excluded from Sum)."""
    return If(And(IsNotNull(x), IsNotNull(y)), term, Literal(None, float64))


def _pair_moments(x: Expression, y: Expression):
    xf, yf = _f(x), _f(y)
    n = _f(Count(_guard2(x, y, Literal(1.0))))
    sx = Sum(_guard2(x, y, xf))
    sy = Sum(_guard2(x, y, yf))
    sxy = Sum(_guard2(x, y, Multiply(xf, yf)))
    sxx = Sum(_guard2(x, y, Multiply(xf, xf)))
    syy = Sum(_guard2(x, y, Multiply(yf, yf)))
    return n, sx, sy, sxy, sxx, syy


def corr(x: Expression, y: Expression) -> Expression:
    n, sx, sy, sxy, sxx, syy = _pair_moments(x, y)
    num = Subtract(Multiply(n, sxy), Multiply(sx, sy))
    dx = Subtract(Multiply(n, sxx), Multiply(sx, sx))
    dy = Subtract(Multiply(n, syy), Multiply(sy, sy))
    return Divide(num, Sqrt(Multiply(dx, dy)))


def covar_pop(x: Expression, y: Expression) -> Expression:
    n, sx, sy, sxy, _, _ = _pair_moments(x, y)
    return Divide(Subtract(sxy, Divide(Multiply(sx, sy), n)), n)


def covar_samp(x: Expression, y: Expression) -> Expression:
    n, sx, sy, sxy, _, _ = _pair_moments(x, y)
    return Divide(Subtract(sxy, Divide(Multiply(sx, sy), n)),
                  Subtract(n, Literal(1.0)))


def _central_moments(x: Expression):
    xf = _f(x)
    n = _f(Count(x))
    s1 = Sum(xf)
    s2 = Sum(Multiply(xf, xf))
    s3 = Sum(Multiply(Multiply(xf, xf), xf))
    s4 = Sum(Multiply(Multiply(xf, xf), Multiply(xf, xf)))
    mu = Divide(s1, n)
    m2 = Subtract(Divide(s2, n), Multiply(mu, mu))
    # m3 = E[x³] − 3μE[x²] + 2μ³
    m3 = Subtract(
        Divide(s3, n),
        Subtract(Multiply(Literal(3.0), Multiply(mu, Divide(s2, n))),
                 Multiply(Literal(2.0), Multiply(mu, Multiply(mu, mu)))))
    # m4 = E[x⁴] − 4μE[x³] + 6μ²E[x²] − 3μ⁴
    mu2 = Multiply(mu, mu)
    m4 = Subtract(
        Divide(s4, n),
        Subtract(
            Multiply(Literal(4.0), Multiply(mu, Divide(s3, n))),
            Subtract(Multiply(Literal(6.0), Multiply(mu2, Divide(s2, n))),
                     Multiply(Literal(3.0), Multiply(mu2, mu2)))))
    return n, mu, m2, m3, m4


def skewness(x: Expression) -> Expression:
    n, _, m2, m3, _ = _central_moments(x)
    return Divide(m3, Sqrt(Multiply(Multiply(m2, m2), m2)))


def kurtosis(x: Expression) -> Expression:
    """Excess kurtosis m4/m2² − 3 (Spark semantics)."""
    n, _, m2, _, m4 = _central_moments(x)
    return Subtract(Divide(m4, Multiply(m2, m2)), Literal(3.0))
