"""Box-constrained quasi-Newton optimization.

The reference vendors a 6k-line Fortran-to-C L-BFGS-B translation
(/root/reference/shared/bfgs.cpp, unlinked in ngsDist; used by sibling
ngsTools for likelihood maximization under bound constraints).  The
JAX equivalent is a projected L-BFGS (the PQN recipe: two-loop
recursion on the PROJECTED gradient, direction masked on the active
set, Armijo backtracking along the projection arc), written as one
jitted `lax.while_loop` with fixed-shape curvature memory — no Fortran,
no numerical gradients, and it batches/vmaps like everything else in
JAX.  Oracle-tested against scipy's L-BFGS-B on problems with bounds
active at the solution (tests/test_popgen.py::TestLbfgsbOracle).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp


class LbfgsbResult(NamedTuple):
    x: jnp.ndarray
    fun: jnp.ndarray
    n_iter: jnp.ndarray
    converged: jnp.ndarray


def _fd_value_and_grad(fun: Callable, lo: jnp.ndarray, hi: jnp.ndarray):
    """Numerical value-and-grad via the reference's recipe: Yang central
    differences with per-coordinate step eh = (1e-8*(|x_i|+1))^0.67 and
    a double-step one-sided shift when a probe would cross a bound
    (/root/reference/shared/bfgs.cpp:22-43 Yanggradient), then the
    active-set zeroing getgradient applies to what it hands L-BFGS-B
    (bfgs.cpp:57-63).  Batched: the 2n probe points evaluate as ONE
    vmapped batch instead of the reference's serial loop, so fun only
    needs to be jax-traceable, not differentiable."""

    def vg(x):
        dtype = x.dtype
        n = x.shape[0]
        f0 = fun(x)
        eh = (1e-8 * (jnp.abs(x) + 1.0)) ** 0.67
        E = jnp.eye(n, dtype=dtype) * eh[:, None]  # row i = eh_i * e_i
        lo_hit = (x - eh) < lo  # backward probe would cross the bound
        hi_hit = (x + eh) > hi  # forward probe would cross the bound
        X = jnp.broadcast_to(x, (n, n))
        # g_i = (f(A_i) - f(B_i)) / (2 eh_i):
        #   interior: A = x+eh e_i, B = x-eh e_i
        #   at lower: A = x+2eh e_i, B = x      (bfgs.cpp:36)
        #   at upper: A = x,        B = x-2eh e_i (bfgs.cpp:38)
        A = jnp.where(lo_hit[:, None], X + 2 * E,
                      jnp.where(hi_hit[:, None], X, X + E))
        B = jnp.where(lo_hit[:, None], X,
                      jnp.where(hi_hit[:, None], X - 2 * E, X - E))
        g = (jax.vmap(fun)(A) - jax.vmap(fun)(B)) / (2.0 * eh)
        # active-set projection of the returned gradient (bfgs.cpp:57-63)
        g = jnp.where((x <= lo) & (g > 0), 0.0, g)
        g = jnp.where((x >= hi) & (g < 0), 0.0, g)
        return f0, g

    return vg


def lbfgsb(
    fun: Callable,
    x0: jnp.ndarray,
    lower: Optional[jnp.ndarray] = None,
    upper: Optional[jnp.ndarray] = None,
    max_iter: int = 100,
    tol: float = 1e-8,
    memory_size: int = 10,
    max_ls: int = 30,
    grad="autodiff",
) -> LbfgsbResult:
    """Minimize fun(x) subject to lower <= x <= upper.

    Stops when the projected-gradient infinity norm falls below tol or
    after max_iter iterations.  jit-compatible.

    grad selects the gradient source, mirroring the reference's
    findmax_bfgs dfun argument (/root/reference/shared/bfgs.h:37-38 —
    "send NULL to use numerical derivative"):
      "autodiff" (default): jax.value_and_grad — fun must be
          jax-differentiable;
      None: Yang central differences (_fd_value_and_grad) — fun only
          needs to be jax-traceable (e.g. contains lax.stop_gradient,
          custom primitives without JVPs, table lookups);
      a callable g(x) -> dfdx: user-supplied analytic gradient.
    """
    dtype = x0.dtype
    n = x0.shape[0]
    m = memory_size
    lo = jnp.full_like(x0, -jnp.inf) if lower is None else jnp.broadcast_to(
        jnp.asarray(lower, dtype), x0.shape)
    hi = jnp.full_like(x0, jnp.inf) if upper is None else jnp.broadcast_to(
        jnp.asarray(upper, dtype), x0.shape)
    eps_active = jnp.asarray(1e-12, dtype)

    def project(x):
        return jnp.clip(x, lo, hi)

    def proj_grad(x, g):
        """Gradient with components pushing OUT of an active bound
        zeroed — the first-order feasible-direction gradient."""
        pg = jnp.where((x <= lo + eps_active) & (g > 0), 0.0, g)
        pg = jnp.where((x >= hi - eps_active) & (g < 0), 0.0, pg)
        return pg

    def pg_norm(x, g):
        return jnp.max(jnp.abs(proj_grad(x, g)))

    x0 = project(x0)
    if grad == "autodiff":
        vg = jax.value_and_grad(fun)
    elif grad is None:
        vg = _fd_value_and_grad(fun, lo, hi)
    else:
        vg = lambda x: (fun(x), grad(x))  # noqa: E731
    f0, g0 = vg(x0)

    # Fixed-shape circular curvature memory.
    S0 = jnp.zeros((m, n), dtype)
    Y0 = jnp.zeros((m, n), dtype)
    rho0 = jnp.zeros((m,), dtype)  # 1/(s'y); 0 marks an empty slot

    def two_loop(pg, S, Y, rho, gamma):
        """L-BFGS two-loop recursion on the projected gradient."""
        def bwd(i, carry):
            q, alpha = carry
            a = rho[i] * jnp.dot(S[i], q)
            q = q - jnp.where(rho[i] != 0.0, a, 0.0) * Y[i]
            return q, alpha.at[i].set(a)

        q, alpha = jax.lax.fori_loop(
            0, m, lambda k, c: bwd(m - 1 - k, c), (pg, jnp.zeros((m,), dtype))
        )
        r = gamma * q

        def fwd(i, r):
            b = rho[i] * jnp.dot(Y[i], r)
            return r + jnp.where(rho[i] != 0.0, alpha[i] - b, 0.0) * S[i]

        return jax.lax.fori_loop(0, m, fwd, r)

    c1 = jnp.asarray(1e-4, dtype)

    def body(state):
        it, x, f, g, S, Y, rho, gamma, slot = state
        pg = proj_grad(x, g)
        d = -two_loop(pg, S, Y, rho, gamma)
        # keep the direction inside the feasible cone and a descent dir
        d = jnp.where((x <= lo + eps_active) & (d < 0), 0.0, d)
        d = jnp.where((x >= hi - eps_active) & (d > 0), 0.0, d)
        descent = jnp.dot(d, g)
        bad = descent >= -1e-12 * jnp.linalg.norm(d) * jnp.linalg.norm(g)
        d = jnp.where(bad, -pg, d)
        descent = jnp.dot(d, g)

        # Armijo backtracking along the projection arc:
        #   x(t) = project(x + t d),  accept when
        #   f(x(t)) <= f + c1 * g'(x(t) - x)
        def ls_cond(ls):
            k, t, _xn, fn, ok = ls
            return jnp.logical_and(k < max_ls, ~ok)

        def ls_body(ls):
            k, t, _xn, _fn, _ok = ls
            xn = project(x + t * d)
            fn = fun(xn)
            ok = fn <= f + c1 * jnp.dot(g, xn - x)
            # a zero step (fully clipped) can never satisfy strict
            # decrease on flat regions; accept equality then
            ok = jnp.logical_or(ok, jnp.all(xn == x))
            t_next = jnp.where(ok, t, t * 0.5)
            return k + 1, t_next, xn, fn, ok

        xn0 = project(x + d)
        _, _, xn, fn, ok = jax.lax.while_loop(
            ls_cond, ls_body,
            (jnp.asarray(0, jnp.int32), jnp.asarray(1.0, dtype), xn0,
             fun(xn0), jnp.asarray(False)),
        )
        fn, gn = vg(xn)

        s = xn - x
        y = gn - g
        sy = jnp.dot(s, y)
        good = sy > 1e-10 * jnp.linalg.norm(s) * jnp.linalg.norm(y)
        S = jnp.where(good, S.at[slot].set(s), S)
        Y = jnp.where(good, Y.at[slot].set(y), Y)
        rho = jnp.where(good, rho.at[slot].set(1.0 / jnp.where(sy != 0, sy, 1.0)),
                        rho)
        gamma = jnp.where(good, sy / jnp.dot(y, y), gamma)
        slot = jnp.where(good, (slot + 1) % m, slot)
        return it + 1, xn, fn, gn, S, Y, rho, gamma, slot

    def cond(state):
        it, x, _f, g, *_ = state
        return jnp.logical_and(it < max_iter, pg_norm(x, g) > tol)

    init = (jnp.asarray(0, jnp.int32), x0, f0, g0, S0, Y0, rho0,
            jnp.asarray(1.0, dtype), jnp.asarray(0, jnp.int32))
    it, x, f, g, *_ = jax.lax.while_loop(cond, body, init)
    return LbfgsbResult(x=x, fun=f, n_iter=it, converged=pg_norm(x, g) <= tol)
