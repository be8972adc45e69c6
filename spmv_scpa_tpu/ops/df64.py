"""Double-float (df64) arithmetic: fp64-grade accumulation in f32.

To match the reference's fp64 serial oracle (csr.c:201-216) tighter
than plain f32 allows without device f64 (SURVEY.md section 7, hard
part #2), we carry values as an unevaluated pair ``hi + lo`` of f32
(Dekker/Knuth error-free transformations):

* ``two_sum``  — exact sum of two f32 into (hi, lo), 6 flops;
* ``split``    — Dekker split of an f32 into high/low halves;
* ``two_prod`` — exact product into (hi, lo) via split (no FMA
  primitive is exposed portably);
* ``df64_add``/``df64_mul`` — double-float ops on pairs.

This yields ~49 effective mantissa bits — far beyond the reference's
1e-1 absolute L2 epsilon (utils.c:53) and enough for rel-err ~1e-12 on
the benchmark suite. Used by the ``xla-ell-df64`` strategy (ops/xla.py).

All ops require IEEE f32 multiply/add; staying elementwise keeps them
off any reduced-precision matrix unit.
"""

from __future__ import annotations

import jax.numpy as jnp

_SPLITTER = 4097.0  # 2**12 + 1 for f32 (24-bit mantissa)


def two_sum(a, b):
    """Knuth exact addition: a + b = s + e with s = fl(a+b)."""
    s = a + b
    v = s - a
    e = (a - (s - v)) + (b - v)
    return s, e


def fast_two_sum(a, b):
    """Dekker exact addition, requires |a| >= |b|."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a):
    """Dekker split: a = hi + lo with hi, lo having 12-bit mantissas."""
    t = _SPLITTER * a
    hi = t - (t - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Exact product: a * b = p + e with p = fl(a*b)."""
    p = a * b
    a_hi, a_lo = split(a)
    b_hi, b_lo = split(b)
    e = ((a_hi * b_hi - p) + a_hi * b_lo + a_lo * b_hi) + a_lo * b_lo
    return p, e


def df64_add(x, y):
    """(hi, lo) + (hi, lo) -> (hi, lo)."""
    x_hi, x_lo = x
    y_hi, y_lo = y
    s, e = two_sum(x_hi, y_hi)
    e = e + x_lo + y_lo
    return fast_two_sum(s, e)


def df64_add_f32(x, a):
    """(hi, lo) + f32 -> (hi, lo)."""
    x_hi, x_lo = x
    s, e = two_sum(x_hi, a)
    return fast_two_sum(s, e + x_lo)


def df64_from_prod(a, b):
    """f32 * f32 as a df64 pair."""
    return two_prod(a, b)


def df64_to_f64_host(hi, lo):
    """Combine on host in float64 (for validation)."""
    import numpy as np
    return np.asarray(hi, np.float64) + np.asarray(lo, np.float64)


def df64_from_f64(v):
    """Split a host float64 array into a df64 pair of f32."""
    import numpy as np
    v = np.asarray(v, np.float64)
    hi = v.astype(np.float32)
    lo = (v - hi.astype(np.float64)).astype(np.float32)
    return jnp.asarray(hi), jnp.asarray(lo)
