"""Top-level dispatch: one ``solve()`` for every method in both domains.

Replaces the reference's three real dispatchers (``lcg_solver`` /
``lcg_solver_preconditioned`` / ``lcg_solver_constrained``,
``src/lib/lcg.cpp:59-140``) and the complex ``clcg_solver`` family
(clcg.cpp:46-74, clcg_eigen.cpp:47-96) with a single jitted entry point.
Method names accept both the short form ("cg", "bicgstab2", ...) and the
reference enum spellings ("LCG_CG", "CLCG_TFQMR", ... — the strings
``lcg_select_solver`` recognises, util.cpp:39-51 / :157-166).

The compiled solve is cached per (method, params, operator structure): the
parameters dataclass is static jit metadata, mirroring how the reference
bakes ``lcg_para`` into each call.
"""

from __future__ import annotations

from functools import partial
from typing import Callable, Optional, Union

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from .operators import LinearOperator, aslinearoperator
from .solvers import cplx as _cplx
from .solvers import real as _real
from .types import DEFAULT_PARAMS, SolverParams, SolveResult, Status

#: method name -> (module domain, function, needs_M, needs_bounds)
_REAL_METHODS = {
    "cg": (_real.cg, False, False),
    "pcg": (_real.pcg, True, False),
    "cg_fused": (_real.cg_fused, False, False),
    "cg_pipelined": (_real.cg_pipelined, False, False),
    "pcg_pipelined": (_real.pcg_pipelined, True, False),
    "cgs": (_real.cgs, False, False),
    "bicgstab": (_real.bicgstab, False, False),
    "bicgstab2": (_real.bicgstab2, False, False),
    "pg": (_real.pg, False, True),
    "spg": (_real.spg, False, True),
}
_CPLX_METHODS = {
    "bicg": (_cplx.bicg, False, False),
    "bicg_sym": (_cplx.bicg_sym, False, False),
    "cgs": (_cplx.cgs, False, False),
    "bicgstab": (_cplx.bicgstab, False, False),
    "tfqmr": (_cplx.tfqmr, False, False),
    "pcg": (_cplx.pcg, True, False),
    "pbicg": (_cplx.pbicg, True, False),
}

#: Reference enum spellings (util.cpp:39-51, :157-166) -> short names,
#: plus short aliases for the pipelined and block variants.
_ALIASES = {
    "cgf": "cg_fused",
    "cgp": "cg_pipelined",
    "pcgp": "pcg_pipelined",
    "bcg": "block_cg",
    "bpcg": "block_pcg",
    "ca_cg": "cacg",
    "sstep_cg": "cacg",
    "LCG_CG": "cg",
    "LCG_PCG": "pcg",
    "LCG_CGS": "cgs",
    "LCG_BICGSTAB": "bicgstab",
    "LCG_BICGSTAB2": "bicgstab2",
    "LCG_PG": "pg",
    "LCG_SPG": "spg",
    "CLCG_BICG": "bicg",
    "CLCG_BICG_SYM": "bicg_sym",
    "CLCG_CGS": "cgs",
    "CLCG_BICGSTAB": "bicgstab",
    "CLCG_TFQMR": "tfqmr",
    "CLCG_PCG": "pcg",
    "CLCG_PBICG": "pbicg",
}

#: Methods available beyond the per-domain tables (chebyshev/minres/cacg
#: are real-domain and raise for complex systems; gmres handles both).
_EXTRA_METHODS = ("chebyshev", "gmres", "pgmres", "minres", "pminres",
                  "cacg")

#: Multi-RHS-only methods (shared block Krylov space, solvers/block.py):
#: real SPD systems, dispatched through :func:`solve_batched` exclusively.
_BLOCK_METHODS = ("block_cg", "block_pcg")

#: Suggested preconditioned counterpart, for the M-with-unpreconditioned-
#: method error message (the reference routes preconditioned solves to a
#: separate dispatcher, lcg.cpp:87-91; passing M anywhere else is a bug).
_PRECONDITIONED_OF = {
    "cg": "pcg", "cg_fused": "pcg", "cg_pipelined": "pcg_pipelined",
    "gmres": "pgmres", "minres": "pminres", "bicg": "pbicg",
    "bicg_sym": "pbicg", "cgs": "pcg", "bicgstab": "pcg",
    "bicgstab2": "pcg", "tfqmr": "pcg", "chebyshev": "pcg",
    "block_cg": "block_pcg", "cacg": "pcg",
}

REAL_METHODS = tuple(_REAL_METHODS) + _EXTRA_METHODS

#: Public: the multi-RHS-only methods — valid for solve_batched /
#: solve_sharded (2-D B), rejected by solve() (kept OUT of REAL_METHODS
#: so that every REAL_METHODS member remains a valid solve() method).
BLOCK_METHODS = _BLOCK_METHODS
COMPLEX_METHODS = tuple(_CPLX_METHODS) + ("gmres", "pgmres")


def canonical_method(method: str) -> str:
    """Resolve a method name or reference enum spelling to its short name."""
    m = _ALIASES.get(method, method).lower()
    if (m not in _REAL_METHODS and m not in _CPLX_METHODS
            and m not in _EXTRA_METHODS and m not in _BLOCK_METHODS):
        raise ValueError(
            f"unknown solver {method!r}; real methods: {sorted(REAL_METHODS)}, "
            f"complex methods: {sorted(COMPLEX_METHODS)}, "
            f"multi-RHS-only: {sorted(_BLOCK_METHODS)}"
        )
    return m


_CHEB_CACHE: dict = {}
_GMRES_CACHE: dict = {}
_CACG_CACHE: dict = {}


def _resolve_engine(m: str, is_complex: bool, A=None, lmin=None, lmax=None,
                    restart: int = 32, s: int = 4):
    """(engine fn, needs_M, needs_bounds) for a canonical method name.

    Chebyshev gets its spectral interval baked into a cached engine: bounds
    default to Gershgorin circles of the concrete operator (ops.spectra),
    and a non-positive lower bound is clamped (Chebyshev needs the interval
    strictly inside the right half-line for SPD systems).  GMRES bakes its
    restart length the same way.
    """
    if m in _BLOCK_METHODS:
        from .solvers.block import block_cg, block_pcg

        if is_complex:
            raise ValueError(
                "block_cg/block_pcg are real-SPD methods; for complex "
                "systems realify the operator first"
            )
        if m == "block_pcg":
            return block_pcg, True, False
        return block_cg, False, False
    if m in ("minres", "pminres"):
        from .solvers.minres import minres as _minres
        from .solvers.minres import pminres as _pminres

        if is_complex:
            raise ValueError(
                "minres is real-domain; for complex-symmetric systems use "
                "bicg_sym, or realify for Hermitian"
            )
        if m == "pminres":
            return _pminres, True, False
        return _minres, False, False
    if m in ("gmres", "pgmres"):
        from .solvers.gmres import gmres as _gmres

        key = int(restart)
        fn = _GMRES_CACHE.get(key)
        if fn is None:
            fn = partial(_gmres, restart=key)
            _GMRES_CACHE[key] = fn
        return fn, m == "pgmres", False
    if m == "cacg":
        from .solvers.sstep import ca_cg as _ca_cg

        if is_complex:
            raise ValueError("cacg is real-domain (SPD systems); realify "
                             "complex operators first")
        if lmin is None or lmax is None:
            from .ops.spectra import gershgorin_bounds

            glo, ghi = gershgorin_bounds(A)
            lmin = glo if lmin is None else lmin
            lmax = ghi if lmax is None else lmax
        # The Chebyshev BASIS (unlike the Chebyshev solver) tolerates
        # lmin = 0 — it only shapes the polynomial recurrence.
        lmin, lmax = max(float(lmin), 0.0), float(lmax)
        key = (lmin, lmax, int(s))
        fn = _CACG_CACHE.get(key)
        if fn is None:
            fn = partial(_ca_cg, s=int(s), lmin=lmin, lmax=lmax,
                         basis="chebyshev")
            _CACG_CACHE[key] = fn
        return fn, False, False
    if m == "chebyshev":
        if is_complex:
            raise ValueError("chebyshev is real-domain (SPD systems)")
        if lmin is None or lmax is None:
            from .ops.spectra import gershgorin_bounds

            glo, ghi = gershgorin_bounds(A)
            lmin = glo if lmin is None else lmin
            lmax = ghi if lmax is None else lmax
        lmin, lmax = float(lmin), float(lmax)
        if lmin <= 0.0:
            lmin = 1e-8 * max(lmax, 1.0)
        key = (lmin, lmax)
        fn = _CHEB_CACHE.get(key)
        if fn is None:
            fn = partial(_real.chebyshev, lmin=lmin, lmax=lmax)
            _CHEB_CACHE[key] = fn
        return fn, False, False
    table = _CPLX_METHODS if is_complex else _REAL_METHODS
    if m not in table:
        dom = "complex" if is_complex else "real"
        raise ValueError(f"method {m!r} is not available in the {dom} domain")
    return table[m]


_JIT_CACHE: dict = {}

_COMPLEX_OK: dict = {}


def _check_complex_backend():
    """Fail FAST with routing guidance when the default backend has no
    complex dtypes (such a backend raises a deferred, cryptic
    ``UNIMPLEMENTED`` error only when the result is materialized).  Probed
    once per backend with a tiny dispatch and cached.  CPU and GPU
    backends pass."""
    plat = jax.default_backend()
    ok = _COMPLEX_OK.get(plat)
    if ok is None:
        try:
            np.asarray(jnp.asarray(1.0 + 1.0j) * 1.0)
            ok = True
        except Exception:
            ok = False
        _COMPLEX_OK[plat] = ok
    if not ok:
        raise ValueError(
            f"complex dtypes are unsupported on the {plat!r} backend "
            f"(materialization raises UNIMPLEMENTED).  Route complex "
            f"systems through real arithmetic instead: "
            f"lcg.solve_realified(A, b, method=...) runs the complex "
            f"engines in [re; im]-pair form; diagonal-plus-scattered "
            f"patterns have the exact lcg.ScatteredDirectSolver; banded "
            f"systems can use realify_coo + DIA (see PARITY.md's "
            f"realified-complex decision tree)."
        )


def _compiled_solver(
    fn, params, monitor, trace_len, needs_M, needs_bounds, takes_key,
    static_M=None, bounds_inclusive=(True, True),
):
    """jit-compile (and cache) one solver configuration.

    The cache key captures everything static: the engine function, the
    parameter struct (hashable dataclass), the monitor callable, and which
    optional operands the engine takes.  Repeated solves with the same
    configuration and shapes then hit XLA's compiled-executable cache — the
    analogue of the reference reusing caller-owned scratch vectors across
    repeated solves (lcg.h:116-137), but for compilations.

    ``static_M`` carries a bare-callable preconditioner (the reference's
    ``Mfp`` function pointer, lcg.h:44-45) in the closure; operator-valued
    preconditioners are pytrees and travel as traced operands instead.
    """
    cache_key = (
        fn, params, monitor, trace_len, needs_M, needs_bounds, takes_key,
        static_M, bounds_inclusive,
    )
    cached = _JIT_CACHE.get(cache_key)
    if cached is not None:
        return cached

    def run(A, b, x0, *extras):
        from .solvers import harness as H

        kwargs = dict(params=params, monitor=monitor, trace_len=trace_len)
        i = 0
        if needs_M:
            if static_M is not None:
                kwargs["M"] = static_M
            else:
                kwargs["M"] = extras[i]
                i += 1
        if needs_bounds:
            kwargs["lower"] = extras[i]
            kwargs["upper"] = extras[i + 1]
            i += 2
            if bounds_inclusive != (True, True):
                kwargs["lower_inclusive"] = bounds_inclusive[0]
                kwargs["upper_inclusive"] = bounds_inclusive[1]
        if takes_key:
            kwargs["key"] = extras[i]
        with H.reduction_dtype(params.reduce_dtype):
            return fn(A, b, x0, **kwargs)

    jitted = jax.jit(run)
    _JIT_CACHE[cache_key] = jitted
    return jitted


def _error_result(x, status: Status) -> SolveResult:
    return SolveResult(
        x=x,
        status_code=jnp.asarray(int(status), jnp.int32),
        iterations=jnp.asarray(0, jnp.int32),
        residual=jnp.asarray(jnp.nan),
        trace=None,
    )


def _solve_cacg_jacobi(A, b, x0, *, M, params, monitor, trace_len,
                       lmin, lmax, s, check):
    """Jacobi-preconditioned s-step CG, by change of variables.

    PCG with ``M = D`` is exactly CG on the symmetrically scaled system
    ``(D^{-1/2} A D^{-1/2}) x̂ = D^{-1/2} b`` with ``x = D^{-1/2} x̂`` —
    the identity the reference's own Jacobi samples rely on (sample1's
    ``p = 1/diag``, sample1.cpp:98-107; CUDA diag-extract + elementwise
    divide, sample10.cu:193).  This composes Jacobi preconditioning
    with the s-step engine WITHOUT a preconditioned recurrence: the
    scaled operator stays symmetric (and banded/sparse), so the whole
    cacg machinery — Chebyshev basis, fused Gram, coefficient algebra,
    2-reduction-rounds-per-s-iterations economy — applies unchanged.

    Semantics notes: the stopping metric is evaluated on the SCALED
    residual ``D^{-1/2}(b - A x)`` (the M⁻¹-weighted norm classic PCG
    implicitly tracks via zᵀr), so iteration counts track
    ``method="pcg"`` closely but not bit-exactly (the reference lpcg
    stops on the unscaled ‖r‖², lcg.cpp:293-434).  A non-positive
    diagonal produces NaN in the scaling and exits with
    Status.NAN_VALUE (SPD systems have positive diagonals).  Spectral
    bounds default to a 20-step power iteration on the scaled operator
    (Gershgorin circles of S A S are not derivable from A's), so pass
    lmin/lmax to skip that one-time estimate when known.
    """
    from .operators import SymScaledOperator
    from .precond.jacobi import JacobiPreconditioner

    if not isinstance(M, JacobiPreconditioner):
        raise ValueError(
            "method 'cacg' supports diagonal (Jacobi) preconditioning "
            "only — it solves the symmetrically scaled system, which "
            "requires M^{-1} to be a diagonal; got "
            f"{type(M).__name__}.  Use method='pcg' for general M."
        )
    s_vec = jnp.sqrt(M.inv_diag.astype(b.dtype))
    A_s = SymScaledOperator(s_vec, A)
    b_s = s_vec * b
    x0_s = None if x0 is None else jnp.asarray(x0, b.dtype) / s_vec
    if lmax is None:
        from .ops.spectra import power_bound

        lmax = power_bound(A_s)
    mon = None
    if monitor is not None:
        # The user's monitor sees the PHYSICAL iterate x = S x̂.
        mon = lambda xh, r, t: monitor(s_vec * xh, r, t)  # noqa: E731
    inner = solve(
        A_s, b_s, x0_s, method="cacg", params=params, monitor=mon,
        trace_len=trace_len, lmin=0.0 if lmin is None else lmin,
        lmax=lmax, s=s, check=check,
    )
    return SolveResult(
        x=s_vec * inner.x,
        status_code=inner.status_code,
        iterations=inner.iterations,
        residual=inner.residual,
        trace=inner.trace,
    )


def solve(
    A: Union[LinearOperator, jnp.ndarray, Callable],
    b,
    x0=None,
    *,
    method: str = "cg",
    params: SolverParams = DEFAULT_PARAMS,
    M=None,
    lower=None,
    upper=None,
    monitor: Optional[Callable] = None,
    trace_len: int = 0,
    key=None,
    lmin=None,
    lmax=None,
    restart: int = 32,
    s: int = 4,
    check: bool = False,
    lower_inclusive: bool = True,
    upper_inclusive: bool = True,
) -> SolveResult:
    """Solve ``A x = b`` with the selected Krylov method.

    Parameters
    ----------
    A : LinearOperator | 2-D array | callable
        The system operator.  Arrays are wrapped in ``DenseOperator``;
        callables must also pass ``n=`` via ``aslinearoperator`` first.
    b : 1-D array — right-hand side.
    x0 : optional initial guess (reference semantics: the in/out ``m``
        vector, lcg.h:61; defaults to zeros).
    method : solver name (short or reference enum spelling).  Complexity of
        ``b`` (or the operator dtype) picks the domain for the ambiguous
        names ("cgs", "bicgstab", "pcg").
    params : SolverParams — static under jit.
    M : preconditioner (operator or callable applying M^{-1}) for pcg/pbicg;
        ``method="cacg"`` accepts a :class:`JacobiPreconditioner` (solved
        as CG on the symmetrically scaled system, see _solve_cacg_jacobi).
    lower, upper : box bounds for pg/spg.
    lower_inclusive, upper_inclusive : False selects ``lcg_set2box``'s
        exclusive-bound projection (clamp just inside the bound,
        algebra.cpp:50-58); defaults match the reference (algebra.h:92-93).
    monitor : optional traced callback ``(x, residual, t) -> bool``; a True
        return stops the solve with Status.STOP (reference Pfp contract,
        lcg.h:53-54).
    trace_len : if > 0, record the first ``trace_len`` residuals.
    key : PRNG key for the complex CGS/BiCGSTAB/TFQMR shadow residual.
    s : s-step depth for ``method="cacg"`` (iterations advanced per basis
        build; Chebyshev basis on [lmin, lmax], Gershgorin default).
    check : if True, raise LcgError on failure statuses.
    """
    m = canonical_method(method)
    if m in _BLOCK_METHODS:
        raise ValueError(
            f"method {m!r} solves a stack of right-hand sides in one shared "
            f"block Krylov space; call solve_batched(A, B, method={m!r}) "
            f"with B of shape (nrhs, n)"
        )
    b = jnp.asarray(b)
    A = aslinearoperator(A, n=b.shape[0], dtype=b.dtype) if not isinstance(
        A, LinearOperator
    ) else A

    is_complex = jnp.issubdtype(b.dtype, jnp.complexfloating) or jnp.issubdtype(
        jnp.dtype(A.dtype), jnp.complexfloating
    )
    if is_complex:
        _check_complex_backend()
    if m == "cacg" and M is not None:
        return _solve_cacg_jacobi(
            A, b, x0, M=M, params=params, monitor=monitor,
            trace_len=trace_len, lmin=lmin, lmax=lmax, s=s, check=check,
        )
    fn, needs_M, needs_bounds = _resolve_engine(m, is_complex, A=A,
                                                lmin=lmin, lmax=lmax,
                                                restart=restart, s=s)

    # Parameter validation (reference entry checks, lcg.cpp:150-155 etc.).
    err = params.validate(for_method=m)
    if err is not None:
        return _error_result(jnp.zeros_like(b) if x0 is None else x0, err)
    if M is not None and not needs_M:
        raise ValueError(
            f"method {m!r} does not use a preconditioner; M would be "
            f"silently ignored.  Use the preconditioned variant "
            f"({_PRECONDITIONED_OF.get(m, 'pcg')!r}) or drop M."
        )
    if needs_M and M is None:
        return _error_result(
            jnp.zeros_like(b) if x0 is None else x0,
            Status.NULL_PRECONDITION_MATRIX,
        )
    if needs_bounds and (lower is None or upper is None):
        return _error_result(
            jnp.zeros_like(b) if x0 is None else x0, Status.INVALID_POINTER
        )
    if b.ndim != 1:
        return _error_result(b, Status.INVALID_VARIABLE_SIZE)
    if x0 is not None and jnp.shape(x0) != jnp.shape(b):
        return _error_result(b, Status.SIZE_NOT_MATCH)

    takes_key = is_complex and m in ("cgs", "bicgstab", "tfqmr")
    M_static = needs_M and not isinstance(M, LinearOperator)
    jitted = _compiled_solver(
        fn, params, monitor, trace_len, needs_M, needs_bounds, takes_key,
        static_M=M if M_static else None,
        bounds_inclusive=(bool(lower_inclusive), bool(upper_inclusive)),
    )

    x0_arr = jnp.zeros_like(b) if x0 is None else jnp.asarray(x0, dtype=b.dtype)
    extras = []
    if needs_M and not M_static:
        extras.append(M)
    if needs_bounds:
        extras.append(jnp.asarray(lower, dtype=b.real.dtype))
        extras.append(jnp.asarray(upper, dtype=b.real.dtype))
    if takes_key:
        extras.append(jax.random.PRNGKey(1234) if key is None else key)

    carry = jitted(A, b, x0_arr, *extras)

    result = SolveResult(
        x=carry["x"],
        status_code=carry["status"],
        iterations=carry["t"],
        residual=carry["residual"],
        trace=carry.get("trace"),
    )
    if check:
        from .utils.errors import check_status

        check_status(result.status_code, raise_error=True, quiet=True)
    return result


#: Methods supported by the batched multi-RHS path.  Every engine carries
#: per-system scalars through the masked harness — including TFQMR's half
#: steps, PG/SPG's BB/line-search state and BiCGSTAB2 (except its abs_diff
#: mid-iteration exit, guarded separately below).
BATCHED_METHODS = frozenset(
    {"cg", "pcg", "cg_fused", "cg_pipelined", "pcg_pipelined", "cgs", "bicgstab",
     "bicgstab2", "bicg", "bicg_sym", "pbicg", "chebyshev", "pg",
     "spg", "tfqmr", "gmres", "pgmres", "minres", "pminres"}
    | set(_BLOCK_METHODS)
)


class _VmappedOperator:
    """Trace-time adapter mapping a 1-D operator over stacked (nrhs, n)
    vectors with ``jax.vmap`` — built inside the jitted function, so it
    needs no pytree registration."""

    def __init__(self, op):
        self._op = op
        self.shape = getattr(op, "shape", None)
        self.dtype = getattr(op, "dtype", None)

    def mv(self, X):
        return jax.vmap(self._op.mv)(X)

    def rmv(self, X):
        return jax.vmap(self._op.rmv)(X)

    def cmv(self, X):
        return jax.vmap(self._op.cmv)(X)

    def hmv(self, X):
        return jax.vmap(self._op.hmv)(X)


def _solve_block(A, B, X0, m, *, params, M, monitor, trace_len, is_complex,
                 check):
    """Dispatch ``solve_batched(method='block_cg'/'block_pcg')`` to the
    shared-Krylov block engine (solvers/block.py).  Same result contract as
    the vmapped batched path: per-system status/iterations/residual and,
    with ``trace_len > 0``, per-system (nrhs, trace_len) residual rows."""
    from .solvers import harness as H
    from .solvers.block import block_cg

    if is_complex:
        raise ValueError(
            "block_cg/block_pcg are real-SPD methods; for complex systems "
            "realify the operator first (operators.realify_coo) and solve "
            "the interleaved real form"
        )
    err = params.validate(for_method=m)
    if err is not None:
        return _error_result(B if X0 is None else X0, err)
    if m == "block_cg" and M is not None:
        raise ValueError(
            "method 'block_cg' does not use a preconditioner; M would be "
            "silently ignored.  Use 'block_pcg' or drop M."
        )
    if m == "block_pcg" and M is None:
        return _error_result(B, Status.NULL_PRECONDITION_MATRIX)
    X0_arr = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0, dtype=B.dtype)

    M_static = M is not None and not isinstance(M, LinearOperator)
    cache_key = ("block", params, monitor, M is not None,
                 M if M_static else None, trace_len)
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is None:
        def run(A_t, B_t, X0_t, *extras):
            Ab = _VmappedOperator(A_t)
            Mb = None
            if M is not None:
                Mb = (lambda X: jax.vmap(M)(X)) if M_static else \
                    _VmappedOperator(extras[0]).mv
            with H.reduction_dtype(params.reduce_dtype):
                return block_cg(Ab, B_t, X0_t, M=Mb, params=params,
                                monitor=monitor, trace_len=trace_len)

        jitted = jax.jit(run)
        _JIT_CACHE[cache_key] = jitted

    extras = [] if (M is None or M_static) else [M]
    carry = jitted(A, B, X0_arr, *extras)
    result = SolveResult(
        x=carry["x"],
        status_code=carry["status"],
        iterations=carry["t"],
        residual=carry["residual"],
        trace=carry.get("trace"),
    )
    if check:
        from .utils.errors import check_status

        for s in np.asarray(result.status_code):
            check_status(s, raise_error=True, quiet=True)
    return result


def _solve_cacg_batched(A, B, X0, *, params, M, monitor, trace_len,
                        lmin, lmax, s, check):
    """Multi-RHS s-step CA-CG: ``jax.vmap`` over the single-system engine.

    ca_cg freezes converged/stalled systems through per-system masks
    inside its coefficient blocks (``alive``/``accept`` selects), so the
    vmapped while_loop — which keeps stepping every lane until all lanes'
    conditions fail — leaves finished systems EXACTLY frozen: per-system
    iteration counts and iterates match the one-at-a-time path.  ``M``: a JacobiPreconditioner composes by
    symmetric scaling, exactly as in :func:`_solve_cacg_jacobi`.
    """
    from .operators import SymScaledOperator

    # Same domain checks as solve(): cacg is real-SPD, and complex input
    # must fail fast (not run the real engine into NaN, nor hit the
    # deferred UNIMPLEMENTED on complex-less backends).
    if jnp.issubdtype(B.dtype, jnp.complexfloating) or jnp.issubdtype(
            jnp.dtype(A.dtype), jnp.complexfloating):
        _check_complex_backend()
        raise ValueError("cacg is real-domain (SPD systems); realify "
                         "complex operators first")

    s_vec = None
    if M is not None:
        from .precond.jacobi import JacobiPreconditioner

        if not isinstance(M, JacobiPreconditioner):
            raise ValueError(
                "method 'cacg' supports diagonal (Jacobi) preconditioning "
                f"only; got {type(M).__name__}"
            )
        s_vec = jnp.sqrt(M.inv_diag.astype(B.dtype))
        A = SymScaledOperator(s_vec, A)
        B = B * s_vec[None, :]
        if X0 is not None:
            X0 = jnp.asarray(X0, B.dtype) / s_vec[None, :]
        if lmax is None:
            from .ops.spectra import power_bound

            lmax = power_bound(A)
        if lmin is None:
            lmin = 0.0
    err = params.validate(for_method="cacg")
    if err is not None:
        return _error_result(B if X0 is None else X0, err)
    fn, _, _ = _resolve_engine("cacg", False, A=A, lmin=lmin, lmax=lmax,
                               s=s)
    X0_arr = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0, B.dtype)

    scaled = s_vec is not None
    cache_key = ("cacg_batched", fn, params, monitor, trace_len,
                 int(B.shape[0]), scaled)
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is None:
        # s_vec travels as a TRACED argument (when present): baking it
        # into a monitor closure would let a cache hit reuse a previous
        # preconditioner's scaling.
        def run(A_t, B_t, X0_t, *sv):
            # The user's monitor sees the PHYSICAL iterate x = S x-hat,
            # as in the single-RHS Jacobi path (_solve_cacg_jacobi).
            mon = monitor
            if monitor is not None and scaled:
                mon = lambda xh, r_, t_: monitor(sv[0] * xh, r_, t_)  # noqa: E731

            def one(b1, x01):
                return fn(A_t, b1, x01, params=params, monitor=mon,
                          trace_len=trace_len)

            return jax.vmap(one, in_axes=(0, 0))(B_t, X0_t)

        jitted = jax.jit(run)
        _JIT_CACHE[cache_key] = jitted

    carry = jitted(A, B, X0_arr, *((s_vec,) if scaled else ()))
    x = carry["x"]
    if s_vec is not None:
        x = x * s_vec[None, :]
    result = SolveResult(
        x=x,
        status_code=carry["status"],
        iterations=carry["t"],
        residual=carry["residual"],
        trace=carry.get("trace"),
    )
    if check:
        from .utils.errors import check_status

        for st in np.asarray(result.status_code):
            check_status(st, raise_error=True, quiet=True)
    return result


def solve_batched(
    A: Union[LinearOperator, jnp.ndarray, Callable],
    B,
    X0=None,
    *,
    method: str = "cg",
    params: SolverParams = DEFAULT_PARAMS,
    M=None,
    lower=None,
    upper=None,
    monitor: Optional[Callable] = None,
    trace_len: int = 0,
    key=None,
    lmin=None,
    lmax=None,
    restart: int = 32,
    s: int = 4,
    check: bool = False,
) -> SolveResult:
    """Solve ``A x_i = b_i`` for a stack of right-hand sides at once.

    ``B`` is (nrhs, n); the result's ``x`` is (nrhs, n) and ``status`` /
    ``iterations`` / ``residual`` are per-system (nrhs,).  One operator,
    one compiled loop: every iteration applies A to all systems and reduces
    all dot products along the row axis, so the marginal cost of
    additional right-hand sides is small (the iteration's launch and
    reduction count is unchanged).  Systems that converge early are frozen; the loop
    runs until all exit.  ``trace_len > 0`` records per-system residual
    rows: ``result.trace`` is (nrhs, trace_len) — the reference's
    per-iteration progress contract (lcg.h:53-54) per right-hand side.
    The reference has no multi-RHS capability (solves are strictly one
    ``B`` at a time, lcg.h:61).
    """
    from .solvers import harness as H

    m = canonical_method(method)
    if m == "cacg":
        B = jnp.asarray(B)
        if B.ndim != 2:
            raise ValueError(f"B must be (nrhs, n), got shape {B.shape}")
        A = aslinearoperator(A, n=B.shape[1], dtype=B.dtype) if not isinstance(
            A, LinearOperator) else A
        return _solve_cacg_batched(
            A, B, X0, params=params, M=M, monitor=monitor,
            trace_len=trace_len, lmin=lmin, lmax=lmax, s=s, check=check)
    if m not in BATCHED_METHODS:
        raise ValueError(
            f"method {m!r} does not support batched solves; available: "
            f"{sorted(BATCHED_METHODS)}"
        )
    if m == "bicgstab2" and params.abs_diff:
        raise ValueError(
            "bicgstab2 with abs_diff uses a mid-iteration exit that is not "
            "batchable; use abs_diff=0 or solve one system at a time"
        )
    B = jnp.asarray(B)
    if B.ndim != 2:
        raise ValueError(f"B must be (nrhs, n), got shape {B.shape}")
    A = aslinearoperator(A, n=B.shape[1], dtype=B.dtype) if not isinstance(
        A, LinearOperator
    ) else A
    is_complex = jnp.issubdtype(B.dtype, jnp.complexfloating) or jnp.issubdtype(
        jnp.dtype(A.dtype), jnp.complexfloating
    )
    if is_complex:
        _check_complex_backend()
    if m in _BLOCK_METHODS:
        return _solve_block(A, B, X0, m, params=params, M=M, monitor=monitor,
                            trace_len=trace_len, is_complex=is_complex,
                            check=check)
    fn, needs_M, needs_bounds = _resolve_engine(m, is_complex, A=A,
                                                lmin=lmin, lmax=lmax,
                                                restart=restart)

    err = params.validate(for_method=m)
    if err is not None:
        return _error_result(B if X0 is None else X0, err)
    if M is not None and not needs_M:
        raise ValueError(
            f"method {m!r} does not use a preconditioner; M would be "
            f"silently ignored.  Use the preconditioned variant "
            f"({_PRECONDITIONED_OF.get(m, 'pcg')!r}) or drop M."
        )
    if needs_M and M is None:
        return _error_result(B, Status.NULL_PRECONDITION_MATRIX)
    if needs_bounds and (lower is None or upper is None):
        return _error_result(B, Status.INVALID_POINTER)
    if is_complex and not jnp.issubdtype(B.dtype, jnp.complexfloating):
        B = B.astype(A.dtype)
    X0_arr = jnp.zeros_like(B) if X0 is None else jnp.asarray(X0, dtype=B.dtype)

    takes_key = is_complex and m in ("cgs", "bicgstab", "tfqmr")
    M_static = needs_M and not isinstance(M, LinearOperator)

    nrhs = int(B.shape[0])
    cache_key = ("batched", fn, params, monitor, needs_M, needs_bounds,
                 takes_key, M if M_static else None, trace_len, nrhs)
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is None:
        def run(A_t, B_t, X0_t, *extras):
            Ab = _VmappedOperator(A_t)
            kwargs = dict(params=params, monitor=monitor,
                          trace_len=trace_len)
            i = 0
            if needs_M:
                if M_static:
                    kwargs["M"] = (lambda X: jax.vmap(M)(X))
                else:
                    kwargs["M"] = _VmappedOperator(extras[i])
                    i += 1
            if needs_bounds:
                kwargs["lower"] = extras[i]
                kwargs["upper"] = extras[i + 1]
                i += 2
            if takes_key:
                kwargs["key"] = extras[i]
            with H.batched(nrhs=nrhs), H.reduction_dtype(params.reduce_dtype):
                return fn(Ab, B_t, X0_t, **kwargs)

        jitted = jax.jit(run)
        _JIT_CACHE[cache_key] = jitted

    extras = []
    if needs_M and not M_static:
        extras.append(M)
    if needs_bounds:
        rdt = B.real.dtype
        extras.append(jnp.asarray(lower, dtype=rdt))
        extras.append(jnp.asarray(upper, dtype=rdt))
    if takes_key:
        extras.append(jax.random.PRNGKey(1234) if key is None else key)

    carry = jitted(A, B, X0_arr, *extras)
    result = SolveResult(
        x=carry["x"],
        status_code=carry["status"],
        iterations=carry["t"],
        residual=carry["residual"],
        trace=carry.get("trace"),
    )
    if check:
        from .utils.errors import check_status

        for s in np.asarray(result.status_code):
            check_status(s, raise_error=True, quiet=True)
    return result


def solve_sequence(
    A: Union[LinearOperator, jnp.ndarray, Callable],
    b0,
    next_b: Callable,
    num_steps: int,
    *,
    method: str = "cg",
    params: SolverParams = DEFAULT_PARAMS,
    M=None,
    x0=None,
    warm_start: bool = True,
    keep_solutions: bool = True,
    lmin=None,
    lmax=None,
    restart: int = 32,
    s: int = 4,
    check: bool = False,
) -> SolveResult:
    """Solve a chain of DEPENDENT systems ``A x_k = b_k`` in ONE dispatch.

    ``b_0 = b0`` and ``b_{k+1} = next_b(x_k, k)`` (a traced function of
    the previous solution) — the implicit time-stepping / nonlinear
    outer-loop pattern, e.g. backward-Euler diffusion
    ``(I + dt·A) x_{k+1} = x_k`` with ``next_b = lambda x, k: x``.

    Why this exists as an API and not deployment advice: sequential
    dependent solves cannot be batched, so calling :func:`solve` K times
    pays K dispatches and K host synchronisations.  Here the entire
    chain is one ``lax.scan`` of compiled while-loop solves: ONE
    dispatch, K·device-time total.  With ``warm_start``
    each solve starts from the previous solution (the reference's in/out
    ``m`` contract, lcg.h:61, applied across the chain).

    Returns a SolveResult whose leaves carry a leading ``num_steps``
    axis: ``x`` is (num_steps, n) when ``keep_solutions`` else the final
    (n,); ``status``/``iterations``/``residual`` are per-step
    (num_steps,).  Real-domain methods (plus cacg/chebyshev/gmres/
    minres); box-constrained PG/SPG and the random-shadow complex
    engines are excluded.

    ``b0`` may also be a STACK (nrhs, n): the chain then advances nrhs
    systems per step through the batched harness (ensemble implicit
    integration) — per-step leaves gain the nrhs axis and ``next_b``
    receives the whole (nrhs, n) stack.
    """
    m = canonical_method(method)
    b0 = jnp.asarray(b0)
    batched = b0.ndim == 2
    if b0.ndim > 2:
        raise ValueError(f"b0 must be (n,) or (nrhs, n), got {b0.shape}")
    if batched and m not in BATCHED_METHODS:
        raise ValueError(
            f"method {m!r} does not support batched solves; available: "
            f"{sorted(BATCHED_METHODS)}"
        )
    A = aslinearoperator(A, n=b0.shape[-1], dtype=b0.dtype) if not isinstance(
        A, LinearOperator
    ) else A
    is_complex = jnp.issubdtype(b0.dtype, jnp.complexfloating) or \
        jnp.issubdtype(jnp.dtype(A.dtype), jnp.complexfloating)
    if is_complex:
        _check_complex_backend()
    if m in _BLOCK_METHODS or m in ("pg", "spg"):
        raise ValueError(
            f"solve_sequence supports the unconstrained single-RHS "
            f"methods; got {m!r}"
        )
    fn, needs_M, needs_bounds = _resolve_engine(
        m, is_complex, A=A, lmin=lmin, lmax=lmax, restart=restart, s=s)
    if is_complex and m in ("cgs", "bicgstab", "tfqmr"):
        raise ValueError(
            f"complex {m!r} draws a random shadow residual per solve; use "
            f"bicg/bicg_sym/pcg/pbicg in a sequence"
        )
    err = params.validate(for_method=m)
    if err is not None:
        return _error_result(b0, err)
    if M is not None and not needs_M:
        raise ValueError(
            f"method {m!r} does not use a preconditioner; M would be "
            f"silently ignored.  Use the preconditioned variant "
            f"({_PRECONDITIONED_OF.get(m, 'pcg')!r}) or drop M."
        )
    if needs_M and M is None:
        return _error_result(b0, Status.NULL_PRECONDITION_MATRIX)

    M_static = needs_M and not isinstance(M, LinearOperator)
    num_steps = int(num_steps)
    x0_arr = jnp.zeros_like(b0) if x0 is None else jnp.asarray(x0, b0.dtype)

    nrhs = int(b0.shape[0]) if batched else None
    cache_key = ("sequence", fn, params, next_b, num_steps, needs_M,
                 M if M_static else None, bool(warm_start),
                 bool(keep_solutions), nrhs)
    jitted = _JIT_CACHE.get(cache_key)
    if jitted is None:
        def run(A_t, b0_t, x0_t, *extras):
            import contextlib as _cl

            from .solvers import harness as H

            A_use = _VmappedOperator(A_t) if batched else A_t
            kwargs = dict(params=params)
            if needs_M:
                M_t = M if M_static else extras[0]
                if batched:
                    kwargs["M"] = ((lambda V: jax.vmap(M_t)(V)) if M_static
                                   else _VmappedOperator(M_t))
                else:
                    kwargs["M"] = M_t

            def step(carry, k):
                x_prev, b_k = carry
                with _cl.ExitStack() as stack:
                    stack.enter_context(
                        H.reduction_dtype(params.reduce_dtype))
                    if batched:
                        stack.enter_context(H.batched(nrhs=nrhs))
                    c = fn(A_use, b_k, x_prev if warm_start else x0_t,
                           **kwargs)
                x_k = c["x"]
                b_next = jnp.asarray(next_b(x_k, k), b_k.dtype)
                outs = (x_k if keep_solutions else (),
                        c["status"], c["t"], c["residual"])
                return (x_k, b_next), outs

            (x_last, _), (xs, status, t, res) = lax.scan(
                step, (x0_t, b0_t), jnp.arange(num_steps))
            return (xs if keep_solutions else x_last), status, t, res

        jitted = jax.jit(run)
        _JIT_CACHE[cache_key] = jitted

    extras = [] if (not needs_M or M_static) else [M]
    xs, status, t, res = jitted(A, b0, x0_arr, *extras)
    result = SolveResult(x=xs, status_code=status, iterations=t,
                         residual=res, trace=None)
    if check:
        from .utils.errors import check_status

        for st in np.asarray(status):
            check_status(st, raise_error=True, quiet=True)
    return result


# Compatibility shims matching the reference dispatcher names -----------------


def lcg_solver(A, b, x0=None, method="cg", params=DEFAULT_PARAMS, **kw):
    """Analogue of ``lcg_solver`` (lcg.cpp:59-82)."""
    return solve(A, b, x0, method=method, params=params, **kw)


def lcg_solver_preconditioned(A, M, b, x0=None, params=DEFAULT_PARAMS, **kw):
    """Analogue of ``lcg_solver_preconditioned`` (lcg.cpp:87-91): always PCG."""
    return solve(A, b, x0, method="pcg", M=M, params=params, **kw)


def lcg_solver_constrained(
    A, b, lower, upper, x0=None, method="spg", params=DEFAULT_PARAMS, **kw
):
    """Analogue of ``lcg_solver_constrained`` (lcg.cpp:121-140): PG or SPG."""
    return solve(
        A, b, x0, method=method, lower=lower, upper=upper, params=params, **kw
    )


def clcg_solver(A, b, x0=None, method="bicg", params=DEFAULT_PARAMS, **kw):
    """Analogue of ``clcg_solver`` (clcg.cpp:46-74)."""
    return solve(A, b, x0, method=method, params=params, **kw)
