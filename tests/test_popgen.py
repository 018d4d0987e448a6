"""popgen toolkit vs direct numpy transcriptions of the reference C.

Each oracle below is a line-for-line transliteration of the reference
semantics (shared/HMM.cpp, shared/gen_func.cpp:936-1178) in plain numpy
loops; the batched JAX implementations must agree to float64 rounding.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from ngsdist_jax.popgen import (
    backward,
    calc_emission,
    calc_hwe,
    est_maf,
    est_maf_sites,
    forward,
    haplo_freq,
    lbfgsb,
    posterior_decode,
    viterbi,
)

EPS = 1e-5


# ---------------- oracles (reference semantics, numpy loops) -------- #


def _logsum(a):
    m = np.max(a)
    return m + np.log(np.sum(np.exp(a - m)))


def _calc_trans(k, l, q_l, alpha, d):
    stay = np.exp(-alpha * d)
    t = (1 - stay) * q_l
    if k == l:
        t += stay
    return np.log(t)


def _forward_oracle(q, alpha, e, d):
    S, K = e.shape
    Fw = np.zeros((S + 1, K))
    Fw[0] = np.log(q)
    for s in range(1, S + 1):
        for l in range(K):
            tmp = [Fw[s - 1][k] + _calc_trans(k, l, q[l], alpha, d[s - 1])
                   for k in range(K)]
            Fw[s][l] = _logsum(np.array(tmp)) + e[s - 1][l]
    return Fw, _logsum(Fw[S])


def _backward_oracle(q, alpha, e, d):
    S, K = e.shape
    Bw = np.zeros((S + 1, K))
    for s in range(S, 0, -1):
        for k in range(K):
            tmp = [
                _calc_trans(k, l, q[l], alpha, d[s - 1]) + e[s - 1][l] + Bw[s][l]
                for l in range(K)
            ]
            Bw[s - 1][k] = _logsum(np.array(tmp))
    ll = _logsum(Bw[0] + np.log(q))
    return Bw, ll


def _viterbi_oracle(q, alpha, e, d):
    S, K = e.shape
    V = np.zeros((S + 1, K))
    back = np.zeros((S + 1, K), dtype=int)
    V[0] = np.log(q)
    for s in range(1, S + 1):
        for l in range(K):
            tmp = np.array(
                [V[s - 1][k] + _calc_trans(k, l, q[l], alpha, d[s - 1])
                 for k in range(K)]
            )
            back[s][l] = int(np.argmax(tmp))
            V[s][l] = tmp[back[s][l]] + e[s - 1][l]
    path = np.zeros(S + 1, dtype=int)
    path[S] = int(np.argmax(V[S]))
    for s in range(S, 0, -1):
        path[s - 1] = back[s][path[s]]
    return path[1:], np.max(V[S])  # observation states only


def _est_maf_oracle(GLlog, indF, ignore_miss):
    n_ind = GLlog.shape[0]
    num = den = 0.0
    freq = 0.01
    iters = 0
    while True:
        prev = freq
        for i in range(n_ind):
            gl = GLlog[i]
            if ignore_miss and (abs(gl[0] - gl[1]) < EPS and abs(gl[1] - gl[2]) < EPS):
                continue
            if indF is None:
                lp = gl.copy()
            else:
                F = indF[i]
                prior = np.array([
                    (1 - freq) ** 2 + (1 - freq) * freq * F,
                    2 * (1 - freq) * freq - 2 * (1 - freq) * freq * F,
                    freq ** 2 + (1 - freq) * freq * F,
                ])
                lp = gl + np.log(prior)
            pp = np.exp(lp - _logsum(lp))
            F = 0.0 if indF is None else indF[i]
            num += pp[1] + pp[2] * (2 - F)
            den += 2 * pp[1] + (pp[0] + pp[2]) * (2 - F)
        freq = num / den
        done = not (abs(prev - freq) > EPS and iters < 100)
        iters += 1
        if done:
            break
    return freq


_G1 = [[(h >> 1 & 1) + (k >> 1 & 1) for h in range(4)] for k in range(4)]
_G2 = [[(h & 1) + (k & 1) for h in range(4)] for k in range(4)]


def _haplo_oracle(gl1, gl2, maf1, maf2, ignore_miss):
    f = np.array([(1 - maf1) * (1 - maf2), (1 - maf1) * maf2,
                  maf1 * (1 - maf2), maf1 * maf2])
    n = gl1.shape[0]
    for n_iter in range(100):
        last = f.copy()
        ff = np.zeros(4)
        x = 0
        for i in range(n):
            p = [gl1[i], gl2[i]]
            if ignore_miss and any(
                abs(q[0] - q[1]) < EPS and abs(q[1] - q[2]) < EPS for q in p
            ):
                continue
            x += 1
            ssum = sum(
                f[k] * f[h] * p[0][_G1[k][h]] * p[1][_G2[k][h]]
                for k in range(4) for h in range(4)
            )
            for k in range(4):
                tmp = sum(
                    f[k] * f[h] * (p[0][_G1[h][k]] * p[1][_G2[h][k]]
                                   + p[0][_G1[k][h]] * p[1][_G2[k][h]])
                    for h in range(4)
                )
                ff[k] += tmp / ssum
        f = ff / (2 * x)
        f = f / f.sum()
        if np.max(np.abs(f - last)) < EPS:
            break
    return f, n_iter, x


# ---------------- tests -------------------------------------------- #


def _chain(rng, S, K=2):
    q = rng.dirichlet(np.ones(K))
    e = np.log(rng.dirichlet(np.ones(3), size=(S, K)).sum(-1) * rng.random((S, K)) + 1e-3)
    d = rng.integers(1, 50, size=S).astype(float)
    d[S // 2] = np.inf  # chromosome break
    return q, 0.01, e, d


def test_forward_backward_match_oracle():
    rng = np.random.default_rng(0)
    q, alpha, e, d = _chain(rng, 23)
    Fw, ll = forward(jnp.asarray(q), alpha, jnp.asarray(e), jnp.asarray(d))
    Fw_o, ll_o = _forward_oracle(q, alpha, e, d)
    np.testing.assert_allclose(np.asarray(Fw), Fw_o[1:], atol=1e-10)
    np.testing.assert_allclose(float(ll), ll_o, atol=1e-10)

    Bw, llb = backward(jnp.asarray(q), alpha, jnp.asarray(e), jnp.asarray(d))
    Bw_o, llb_o = _backward_oracle(q, alpha, e, d)
    np.testing.assert_allclose(np.asarray(Bw), Bw_o[1:], atol=1e-10)
    np.testing.assert_allclose(float(llb), llb_o, atol=1e-10)
    np.testing.assert_allclose(ll_o, llb_o, atol=1e-9)  # sanity


def test_posterior_normalizes():
    rng = np.random.default_rng(1)
    q, alpha, e, d = _chain(rng, 17)
    post, _ = posterior_decode(jnp.asarray(q), alpha, jnp.asarray(e), jnp.asarray(d))
    np.testing.assert_allclose(
        np.exp(np.asarray(post)).sum(-1), np.ones(17), atol=1e-9
    )


def test_viterbi_matches_oracle():
    rng = np.random.default_rng(2)
    q, alpha, e, d = _chain(rng, 19)
    path, score = viterbi(jnp.asarray(q), alpha, jnp.asarray(e), jnp.asarray(d))
    path_o, score_o = _viterbi_oracle(q, alpha, e, d)
    np.testing.assert_allclose(float(score), score_o, atol=1e-10)
    np.testing.assert_array_equal(np.asarray(path), path_o)


def test_calc_emission():
    gl = np.log(np.array([0.7, 0.2, 0.1]))
    got = float(calc_emission(jnp.asarray(gl), 0.3, 0.5))
    prior = np.asarray(calc_hwe(0.3, 0.5))
    np.testing.assert_allclose(got, _logsum(gl + np.log(prior)), atol=1e-12)


@pytest.mark.parametrize("use_indF", [False, True])
def test_est_maf_matches_oracle(use_indF):
    rng = np.random.default_rng(3)
    N = 20
    GL = np.log(rng.dirichlet(np.ones(3), size=N))
    GL[3] = np.log(1 / 3)  # one missing individual
    indF = rng.random(N) * 0.5 if use_indF else None
    want = _est_maf_oracle(GL, indF, True)
    got = float(est_maf(jnp.asarray(GL), None if indF is None else jnp.asarray(indF)))
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_est_maf_sites_batched():
    rng = np.random.default_rng(4)
    S, N = 9, 12
    GL = np.log(rng.dirichlet(np.ones(3), size=(S, N)))
    got = np.asarray(est_maf_sites(jnp.asarray(GL)))
    for s in range(S):
        np.testing.assert_allclose(
            got[s], _est_maf_oracle(GL[s], None, True), atol=1e-9
        )


def test_haplo_freq_matches_oracle():
    rng = np.random.default_rng(5)
    N = 25
    g1 = rng.dirichlet(np.ones(3), size=N)
    g2 = rng.dirichlet(np.ones(3), size=N)
    g1[2] = 1 / 3  # missing
    f, n_iter, x = haplo_freq(jnp.asarray(g1), jnp.asarray(g2), 0.3, 0.4)
    f_o, n_o, x_o = _haplo_oracle(g1, g2, 0.3, 0.4, True)
    np.testing.assert_allclose(np.asarray(f), f_o, atol=1e-9)
    assert int(x) == x_o
    # the |Δ| < 1e-5 threshold can flip by one iteration between float
    # implementations at the convergence boundary
    assert abs(int(n_iter) - n_o) <= 1


def test_haplo_freq_batched():
    rng = np.random.default_rng(6)
    B, N = 4, 15
    g1 = rng.dirichlet(np.ones(3), size=(B, N))
    g2 = rng.dirichlet(np.ones(3), size=(B, N))
    mafs = rng.random(B) * 0.5
    f, n_iter, x = haplo_freq(jnp.asarray(g1), jnp.asarray(g2), jnp.asarray(mafs), 0.25)
    for b in range(B):
        f_o, _, _ = _haplo_oracle(g1[b], g2[b], mafs[b], 0.25, True)
        np.testing.assert_allclose(np.asarray(f)[b], f_o, atol=1e-8)


def test_lbfgsb_bounded_quadratic():
    target = jnp.asarray([2.0, -3.0, 0.5])

    def fun(x):
        return jnp.sum((x - target) ** 2)

    res = lbfgsb(fun, jnp.zeros(3), lower=jnp.asarray([-1.0, -1.0, -1.0]),
                 upper=jnp.asarray([1.0, 1.0, 1.0]))
    np.testing.assert_allclose(np.asarray(res.x), [1.0, -1.0, 0.5], atol=1e-6)
    assert bool(res.converged)


def test_lbfgsb_rosenbrock_unbounded():
    def rosen(x):
        return jnp.sum(100 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)

    res = lbfgsb(rosen, jnp.zeros(4), max_iter=500, tol=1e-10)
    np.testing.assert_allclose(np.asarray(res.x), np.ones(4), atol=1e-4)


def _joint_oracle(h, gp, gc, F):
    """Direct transcription of HMM.cpp:175-236 (live branch)."""
    def jg(g_p, g_c):
        table = {
            (0, 0): h[0] ** 2 if F == 0 else h[0],
            (0, 1): 2 * h[0] * h[1] if F == 0 else 0.0,
            (0, 2): h[1] ** 2 if F == 0 else h[1],
            (1, 0): 2 * h[0] * h[2] if F == 0 else 0.0,
            (1, 1): 2 * (h[0] * h[3] + h[1] * h[2]) if F == 0 else 0.0,
            (1, 2): 2 * h[1] * h[3] if F == 0 else 0.0,
            (2, 0): h[2] ** 2 if F == 0 else h[2],
            (2, 1): 2 * h[2] * h[3] if F == 0 else 0.0,
            (2, 2): h[3] ** 2 if F == 0 else h[3],
        }
        return table[(g_p, g_c)]

    s = 0.0
    for g_c in range(3):
        for g_p in range(3):
            s += jg(g_p, g_c) * np.exp(gp[g_p]) * np.exp(gc[g_c])
    return s


@pytest.mark.parametrize("F", [0, 1])
def test_calc_emission_ld_matches_oracle(F):
    from ngsdist_jax.popgen import calc_emission_ld

    rng = np.random.default_rng(7)
    h = rng.dirichlet(np.ones(4))
    gp = np.log(rng.dirichlet(np.ones(3)))
    gc = np.log(rng.dirichlet(np.ones(3)))
    maf_p = 0.3
    got = float(calc_emission_ld(jnp.asarray(h), jnp.asarray(gp),
                                 jnp.asarray(gc), maf_p, F))
    prior = np.asarray(calc_hwe(maf_p, float(F)))
    want = np.log(_joint_oracle(h, gp, gc, F)) - _logsum(gp + np.log(prior))
    np.testing.assert_allclose(got, want, atol=1e-10)


class TestLbfgsbOracle:
    """Oracle validation against scipy's L-BFGS-B (the same algorithm
    family as the reference's vendored Fortran translation,
    /root/reference/shared/bfgs.h:6-57) on a 10-problem suite with
    bounds ACTIVE at the solution in nontrivial patterns and with
    ill-conditioning, plus a vmapped batch use."""

    def _problems(self):
        import numpy as np

        probs = []
        # 1-4: convex quadratics x'Ax/2 - b'x with random boxes that cut
        # through the unconstrained optimum (active-set patterns vary).
        for seed in range(4):
            rng = np.random.default_rng(seed)
            n = 6
            Q = rng.normal(size=(n, n))
            A = Q @ Q.T + 0.1 * np.eye(n)
            b = rng.normal(size=n)
            xstar = np.linalg.solve(A, b)
            lo = xstar - rng.uniform(0.0, 1.0, n)
            hi = xstar + rng.uniform(0.0, 1.0, n)
            lo[rng.random(n) < 0.5] = -10.0  # some coords unconstrained below
            # force some bounds active: shift part of the box below xstar
            act = rng.random(n) < 0.5
            hi[act] = xstar[act] - rng.uniform(0.05, 0.3, act.sum())
            lo = np.minimum(lo, hi - 0.1)
            probs.append((
                lambda x, A=jnp.asarray(A), b=jnp.asarray(b):
                    0.5 * x @ (A @ x) - b @ x,
                np.zeros(n), lo, hi,
            ))
        # 5: ill-conditioned quadratic (condition number 1e6)
        n = 8
        d = np.logspace(0, 6, n)
        probs.append((
            lambda x, d=d: 0.5 * jnp.sum(d * x * x) - jnp.sum(x),
            np.ones(n), np.full(n, -2.0), np.full(n, 0.5),
        ))
        # 6: bounded Rosenbrock, optimum outside the box
        probs.append((
            lambda x: (1 - x[0]) ** 2 + 100 * (x[1] - x[0] ** 2) ** 2,
            np.array([-1.0, 1.0]), np.array([-2.0, -2.0]),
            np.array([0.5, 0.8]),
        ))
        # 7: bounded Rosenbrock 4-D, box clips two coords
        probs.append((
            lambda x: jnp.sum((1 - x[:-1]) ** 2)
            + 100 * jnp.sum((x[1:] - x[:-1] ** 2) ** 2),
            np.full(4, 0.2), np.full(4, -0.5), np.array([0.8, 0.7, 2.0, 2.0]),
        ))
        # 8: exp-sum (log-likelihood-like) with one-sided bounds
        probs.append((
            lambda x: jnp.sum(jnp.exp(x) - x * jnp.array([1.0, 2.0, 3.0])),
            np.zeros(3), np.full(3, 0.2), np.full(3, 10.0),
        ))
        # 9: quartic with all-active upper bounds
        probs.append((
            lambda x: jnp.sum((x - 2.0) ** 4),
            np.zeros(5), np.full(5, -1.0), np.full(5, 1.0),
        ))
        # 10: mixed trig/quadratic, partially active
        probs.append((
            lambda x: (x[0] - 0.3) ** 2 + 2 * (x[1] + 0.7) ** 2
            + 0.1 * (x[2] ** 2),
            np.zeros(3), np.array([0.5, -0.5, -1.0]), np.array([2.0, 0.5, 1.0]),
        ))
        return probs

    def test_matches_scipy_lbfgsb(self):
        import numpy as np
        from scipy.optimize import minimize

        from ngsdist_jax.popgen.optim import lbfgsb

        for k, (f, x0, lo, hi) in enumerate(self._problems()):
            def fj(x):
                return f(jnp.asarray(x))

            res = lbfgsb(fj, jnp.asarray(x0, jnp.float64),
                         lower=jnp.asarray(lo), upper=jnp.asarray(hi),
                         max_iter=500, tol=1e-10)
            ref = minimize(
                lambda x: np.float64(fj(jnp.asarray(x))), x0,
                jac=lambda x: np.asarray(
                    jax.grad(fj)(jnp.asarray(x, jnp.float64)), np.float64),
                method="L-BFGS-B", bounds=list(zip(lo, hi)),
                options={"maxiter": 500, "ftol": 1e-15, "gtol": 1e-12},
            )
            assert float(res.fun) <= ref.fun + 1e-6, (
                f"problem {k}: ours {float(res.fun)} vs scipy {ref.fun}"
            )
            np.testing.assert_allclose(np.asarray(res.x), ref.x, atol=2e-4,
                                       err_msg=f"problem {k}")

    def test_numerical_gradient_matches_scipy(self):
        """grad=None engages the reference's numerical-derivative path
        (findmax_bfgs with dfun=NULL -> Yanggradient central
        differences, /root/reference/shared/bfgs.cpp:22-43): the full
        oracle suite must still agree with scipy, which runs its OWN
        finite differences (jac=None)."""
        import numpy as np
        from scipy.optimize import minimize

        from ngsdist_jax.popgen.optim import lbfgsb

        for k, (f, x0, lo, hi) in enumerate(self._problems()):
            def fj(x):
                # stop_gradient severs autodiff: this objective is only
                # traceable, the exact case the FD fallback exists for
                return jax.lax.stop_gradient(f(jnp.asarray(x)))

            res = lbfgsb(fj, jnp.asarray(x0, jnp.float64),
                         lower=jnp.asarray(lo), upper=jnp.asarray(hi),
                         max_iter=500, tol=1e-7, grad=None)
            ref = minimize(
                lambda x: np.float64(fj(jnp.asarray(x))), x0,
                method="L-BFGS-B", bounds=list(zip(lo, hi)),
                options={"maxiter": 500, "ftol": 1e-15, "gtol": 1e-10},
            )
            # FD noise floor: compare achieved objective, looser than
            # the analytic-gradient suite
            assert float(res.fun) <= ref.fun + 1e-5 + 1e-6 * abs(ref.fun), (
                f"problem {k}: ours {float(res.fun)} vs scipy {ref.fun}"
            )

    def test_numerical_gradient_one_sided_at_bounds(self):
        """At a coordinate sitting ON a bound the FD probe must not
        cross it (Yanggradient's double-step shift, bfgs.cpp:35-38):
        an objective UNDEFINED outside the box still optimizes."""
        import numpy as np

        from ngsdist_jax.popgen.optim import lbfgsb

        def f(x):
            # NaN outside [0, 1]^2 — any probe crossing a bound poisons
            # the gradient
            safe = jnp.all((x >= 0.0) & (x <= 1.0))
            v = jnp.sum(jnp.sqrt(jnp.clip(x, 0.0)) * jnp.array([-1.0, -2.0]))
            return jnp.where(safe, v, jnp.nan)

        res = lbfgsb(f, jnp.array([0.0, 1.0], jnp.float64),
                     lower=jnp.zeros(2), upper=jnp.ones(2),
                     max_iter=200, tol=1e-8, grad=None)
        # -sqrt(x0) - 2 sqrt(x1) is minimized at the upper corner (1, 1)
        np.testing.assert_allclose(np.asarray(res.x), [1.0, 1.0], atol=1e-6)
        assert np.isfinite(float(res.fun))

    def test_vmapped_batch(self):
        """Batched use: one compiled solver over many problem instances
        (impossible with the reference's thread-per-problem Fortran)."""
        import numpy as np

        from ngsdist_jax.popgen.optim import lbfgsb

        rng = np.random.default_rng(5)
        centers = jnp.asarray(rng.normal(size=(16, 4)))

        def solve_one(c):
            return lbfgsb(
                lambda x: jnp.sum((x - c) ** 2) + 0.1 * jnp.sum(x ** 4),
                jnp.zeros(4, jnp.float64),
                lower=jnp.full(4, -0.5), upper=jnp.full(4, 0.5),
                max_iter=100, tol=1e-9,
            ).x

        xs = jax.vmap(solve_one)(centers)
        assert xs.shape == (16, 4)
        # every solution is inside the box and matches the per-problem solve
        assert bool(jnp.all(xs >= -0.5 - 1e-12) & jnp.all(xs <= 0.5 + 1e-12))
        x0 = solve_one(centers[0])
        np.testing.assert_allclose(np.asarray(xs[0]), np.asarray(x0), atol=1e-8)
