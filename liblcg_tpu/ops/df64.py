"""df64 — double-float ("two-float") arithmetic for coefficient algebra.

Why this exists: the s-step CA-CG coefficient recurrences
(``solvers/sstep.py``) need ~49+ bits of mantissa (the Gram quadratic
forms cancel below f32 on near-collinear bases — measured: negative
r^T G r at s >= 4 on the 96^3 Laplacian).  Where x64 is on, native f64
serves (``coeff="wide"``).  Where it is off, a double-float number
``x = hi + lo`` with ``|lo| <= ulp(hi)/2`` carries ~2x24 = 48-49 mantissa
bits using ONLY native f32 elementwise ops, which XLA fuses into the
surrounding computation.

The error-free transforms are the classical ones (Dekker 1971; Knuth;
the QD library of Hida, Li & Bailey 2001): ``two_sum`` (6 flops, exact),
Veltkamp ``split`` + ``two_prod`` (FMA-free — XLA/HLO exposes no fused
multiply-add primitive), double-float add/mul/div, and vectorized
dot/matmul built as broadcast two_prod + a binary-tree compensated
reduction (all static-shape, all elementwise — one XLA fusion).

IEEE prerequisite: HLO elementwise f32 ops round correctly (reduced-
precision matmul modes apply to ``dot_general``/conv only, never to
elementwise add/mul), and XLA does not reassociate floats, so the
transforms hold under jit.

A pair is represented as a ``(hi, lo)`` tuple of equal-shape f32 arrays.
NaN/inf propagate through ``hi`` exactly as in plain arithmetic (the
solver's NaN-classification contract is preserved).

No reference counterpart: the reference's highest precision is native
f64 (``src/lib/algebra.cpp:154``); this module serves CA-CG when x64 is
off.
"""

from __future__ import annotations

import numpy as np
import jax.numpy as jnp


_SPLIT = 4097.0  # 2^12 + 1 — Veltkamp constant for binary32 (p=24)


def two_sum(a, b):
    """Knuth two-sum: s + e == a + b exactly, s = fl(a + b)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def quick_two_sum(a, b):
    """Dekker fast two-sum — requires |a| >= |b| (or a == 0)."""
    s = a + b
    return s, b - (s - a)


def split(a):
    """Veltkamp split: a == hi + lo with hi, lo representable in 12 bits."""
    t = a * _SPLIT
    hi = t - (t - a)
    return hi, a - hi


def two_prod(a, b):
    """Dekker two-product (FMA-free): p + e == a * b exactly."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


# ---------------------------------------------------------------------------
# double-float pair arithmetic  (QD-style "accurate" variants)
# ---------------------------------------------------------------------------


def from_array(x, dtype=jnp.float32):
    """Promote an array (any float dtype) to a pair; captures bits beyond
    f32 when the input is wider (hi = round(x), lo = round(x - hi))."""
    x = jnp.asarray(x)
    hi = x.astype(dtype)
    if jnp.dtype(x.dtype).itemsize > jnp.dtype(dtype).itemsize:
        lo = (x - hi.astype(x.dtype)).astype(dtype)
    else:
        lo = jnp.zeros_like(hi)
    return hi, lo


def const(x, dtype=np.float32):
    """Exact pair constants from host f64 values (numpy, trace-time)."""
    x = np.asarray(x, np.float64)
    hi = x.astype(dtype)
    lo = (x - hi.astype(np.float64)).astype(dtype)
    return jnp.asarray(hi), jnp.asarray(lo)


def to_array(x, dtype=None):
    """Collapse a pair to a plain array.  For a wider target dtype the low
    word contributes real bits; for f32 the result is just ``hi``."""
    hi, lo = x
    if dtype is not None and jnp.dtype(dtype).itemsize > hi.dtype.itemsize:
        return hi.astype(dtype) + lo.astype(dtype)
    out = hi + lo          # == hi in f32, but keeps NaN from either word
    return out if dtype is None else out.astype(dtype)


def zeros(shape, dtype=jnp.float32):
    z = jnp.zeros(shape, dtype)
    return z, z


def add(x, y):
    s1, s2 = two_sum(x[0], y[0])
    t1, t2 = two_sum(x[1], y[1])
    s2 = s2 + t1
    s1, s2 = quick_two_sum(s1, s2)
    return quick_two_sum(s1, s2 + t2)


def neg(x):
    return -x[0], -x[1]


def sub(x, y):
    return add(x, neg(y))


def mul(x, y):
    p1, p2 = two_prod(x[0], y[0])
    return quick_two_sum(p1, p2 + (x[0] * y[1] + x[1] * y[0]))


def mul_pow2(x, k: float):
    """Exact scale by a power of two (basis/metric rescalings)."""
    return x[0] * k, x[1] * k


def div(x, y):
    """Long division with two correction terms (QD accurate-div): the
    quotient is correct to ~2^-48 relative — ample for alpha/beta."""
    q1 = x[0] / y[0]
    r = sub(x, _scale_f(y, q1))
    q2 = r[0] / y[0]
    r = sub(r, _scale_f(y, q2))
    q3 = r[0] / y[0]
    s, e = two_sum(q1, q2)
    return add((s, e), (q3, jnp.zeros_like(q3)))


def _scale_f(x, f):
    """pair * plain-f32, exactly rounded."""
    p, e = two_prod(x[0], f)
    return quick_two_sum(p, e + x[1] * f)


def where(cond, x, y):
    return jnp.where(cond, x[0], y[0]), jnp.where(cond, x[1], y[1])


def nonpos(x):
    """sign test on a pair: hi dominates unless it is exactly zero."""
    return jnp.where(x[0] == 0.0, x[1], x[0]) <= 0.0


# ---------------------------------------------------------------------------
# small-dimension linear algebra (static shapes, fully vectorized)
# ---------------------------------------------------------------------------


def _tree_sum(hi, lo, axis):
    """Compensated binary-tree reduction of pairs along ``axis`` —
    log2(n) vectorized df64 adds, no sequential loop for XLA to serialize."""
    hi = jnp.moveaxis(hi, axis, 0)
    lo = jnp.moveaxis(lo, axis, 0)
    n = hi.shape[0]
    while n > 1:
        half = n // 2
        a = (hi[:half], lo[:half])
        b = (hi[half:2 * half], lo[half:2 * half])
        s_hi, s_lo = add(a, b)
        if n % 2:
            hi = jnp.concatenate([s_hi, hi[2 * half:]], axis=0)
            lo = jnp.concatenate([s_lo, lo[2 * half:]], axis=0)
        else:
            hi, lo = s_hi, s_lo
        n = hi.shape[0]
    return hi[0], lo[0]


def dot(x, y):
    """<x, y> over the last axis: elementwise df64 mul + tree reduction
    (an Ogita-Rump-Oishi Dot2-class compensated dot, error O(u^2) n)."""
    p = mul(x, y)
    return _tree_sum(p[0], p[1], -1)


def matvec(m, v):
    """(..., k) @ (k,) — broadcast mul over the last axis + tree-sum."""
    p = mul(m, (v[0][None, :], v[1][None, :]))
    return _tree_sum(p[0], p[1], -1)


def matmul(a, b):
    """(n, k) @ (k, m) pairs — broadcast to (n, m, k) then tree-sum.
    Coefficient-space sizes only (k <= ~16): the broadcast is tiny."""
    ae = (a[0][:, None, :], a[1][:, None, :])
    be = (b[0].T[None, :, :], b[1].T[None, :, :])
    p = mul(ae, be)
    return _tree_sum(p[0], p[1], -1)


def axpy(alpha, x, y):
    """y + alpha * x with a pair scalar alpha and pair vectors."""
    return add(y, mul((jnp.broadcast_to(alpha[0], x[0].shape),
                       jnp.broadcast_to(alpha[1], x[1].shape)), x))


def concat(xs, axis=0):
    return (jnp.concatenate([x[0] for x in xs], axis=axis),
            jnp.concatenate([x[1] for x in xs], axis=axis))


def stack(xs, axis=0):
    return (jnp.stack([x[0] for x in xs], axis=axis),
            jnp.stack([x[1] for x in xs], axis=axis))


def index(x, idx):
    return x[0][idx], x[1][idx]
