"""Independent oracles for the extended evolutionary models (3-6).

core/submodels.py transcribes the K80 / F81 / F84 / TN93 distance
formulas from the literature; the reference aborts on these models
(/root/reference/ngsDist.cpp:387-398), so there is no reference binary
to A/B against.  The prior tests (reductions at equal base frequencies,
one hand-counted K80 case) could not catch a sign or factor slip in the
UNEQUAL-frequency terms.  Two independent oracles close that hole:

1. GENERATIVE INVERSION (the primary oracle): each model is DEFINED by
   a reversible substitution rate matrix.  We build that matrix from
   its primary-source definition, compute the exact transition kernel
   P(t) = expm(Qt) by symmetrized eigendecomposition (pure numpy — a
   reversible Q is similar to a symmetric matrix via diag(sqrt(pi))),
   form the expected pairwise mismatch proportions between two
   sequences at stationarity with total path length t, and assert the
   distance formula recovers t to ~1e-10.  Any sign/factor error in
   any term fails this for generic (pi, rates, t).

2. SCALAR REIMPLEMENTATION: from-paper formulas written independently
   (explicit scalar arithmetic, no shared helpers), compared to the
   vectorized implementation at 1e-12 over random non-degenerate
   compositions and the degenerate reductions.

A mutation-sensitivity meta-test proves the oracle would catch a
deliberately flipped sign in f84's transversion term.

Primary sources: Kimura 1980 (J Mol Evol 16:111, eq. 6); Felsenstein
1981 (J Mol Evol 17:368); F84 as in Felsenstein's PHYLIP dnadist
documentation (also Felsenstein 2004, "Inferring Phylogenies", ch. 11);
Tamura & Nei 1993 (Mol Biol Evol 10:512, eqs. 9-11).
"""

import math

import numpy as np
import pytest

from ngsdist_jax.core import submodels as sm

A, C, G, T = 0, 1, 2, 3
PURINES = (A, G)


# ------------------------------------------------------------------ #
# Generative oracle: rate matrix -> expm -> expected proportions      #
# ------------------------------------------------------------------ #


def _expm_reversible(Q: np.ndarray, pi: np.ndarray, t: float) -> np.ndarray:
    """exp(Q t) for a reversible rate matrix via the symmetric
    similarity  S = D Q D^-1  with D = diag(sqrt(pi)) (pure numpy)."""
    d = np.sqrt(pi)
    S = (Q * d[:, None]) / d[None, :]
    S = (S + S.T) / 2  # kill rounding asymmetry
    w, V = np.linalg.eigh(S)
    E = (V * np.exp(w * t)) @ V.T
    return E * d[None, :] / d[:, None]


def _finish_rates(R: np.ndarray, pi: np.ndarray):
    """Diagonal + mean rate mu = sum_i pi_i sum_{j!=i} q_ij."""
    np.fill_diagonal(R, 0.0)
    np.fill_diagonal(R, -R.sum(axis=1))
    mu = -float(np.sum(pi * np.diag(R)))
    return R, mu


def _rates_tn93(pi, a1, a2, b):
    """TN93 defining rates: q_ij = a1*pi_j (A<->G), a2*pi_j (C<->T),
    b*pi_j (transversions)."""
    R = np.empty((4, 4))
    for i in range(4):
        for j in range(4):
            if i == j:
                continue
            if (i in PURINES) == (j in PURINES):
                R[i, j] = (a1 if i in PURINES else a2) * pi[j]
            else:
                R[i, j] = b * pi[j]
    return _finish_rates(R, pi)


def _rates_f84(pi, kappa, b):
    """F84 defining rates (PHYLIP dnadist): transitions
    q_ij = b*pi_j*(1 + kappa/pi_group(j)), transversions q_ij = b*pi_j,
    with pi_group the frequency of j's purine/pyrimidine class."""
    piR = pi[A] + pi[G]
    piY = pi[C] + pi[T]
    R = np.empty((4, 4))
    for i in range(4):
        for j in range(4):
            if i == j:
                continue
            if (i in PURINES) == (j in PURINES):
                grp = piR if j in PURINES else piY
                R[i, j] = b * pi[j] * (1.0 + kappa / grp)
            else:
                R[i, j] = b * pi[j]
    return _finish_rates(R, pi)


def _expected_props(pi, R, mu, d_true):
    """(P_ag, P_ct, Q_tv) expected pairwise mismatch proportions for two
    stationary sequences at total path length d_true substitutions/site:
    Pr(pair i,j) = pi_i * P(t)_ij with t = d_true / mu."""
    P = _expm_reversible(R, pi, d_true / mu)
    joint = pi[:, None] * P
    p_ag = joint[A, G] + joint[G, A]
    p_ct = joint[C, T] + joint[T, C]
    q_tv = sum(joint[i, j] for i in range(4) for j in range(4)
               if (i in PURINES) != (j in PURINES))
    return p_ag, p_ct, q_tv


PIS = [
    np.array([0.25, 0.25, 0.25, 0.25]),
    np.array([0.1, 0.2, 0.3, 0.4]),
    np.array([0.4, 0.3, 0.2, 0.1]),
    np.array([0.35, 0.15, 0.05, 0.45]),
    np.array([0.05, 0.55, 0.25, 0.15]),
    np.array([0.31, 0.19, 0.23, 0.27]),
]
TS = [0.05, 0.3, 0.8]


@pytest.mark.parametrize("pi", PIS, ids=range(len(PIS)))
@pytest.mark.parametrize("t", TS)
def test_tn93_inverts_its_model(pi, t):
    R, mu = _rates_tn93(pi, a1=4.0, a2=2.0, b=1.0)
    p1, p2, q = _expected_props(pi, R, mu, t)
    d = sm.tn93(np.float64(p1), np.float64(p2), np.float64(q), pi)
    assert d == pytest.approx(t, abs=1e-10)


@pytest.mark.parametrize("pi", PIS, ids=range(len(PIS)))
@pytest.mark.parametrize("t", TS)
def test_f84_inverts_its_model(pi, t):
    R, mu = _rates_f84(pi, kappa=1.5, b=1.0)
    p1, p2, q = _expected_props(pi, R, mu, t)
    d = sm.f84(np.float64(p1 + p2), np.float64(q), pi)
    assert d == pytest.approx(t, abs=1e-10)


@pytest.mark.parametrize("pi", PIS, ids=range(len(PIS)))
@pytest.mark.parametrize("t", TS)
def test_f81_inverts_its_model(pi, t):
    # F81: q_ij = pi_j (TN93 with a1 = a2 = b = 1)
    R, mu = _rates_tn93(pi, a1=1.0, a2=1.0, b=1.0)
    p1, p2, q = _expected_props(pi, R, mu, t)
    d = sm.f81(np.float64(p1 + p2 + q), pi)
    assert d == pytest.approx(t, abs=1e-10)


@pytest.mark.parametrize("t", TS)
def test_k80_inverts_its_model(t):
    pi = PIS[0]  # K80 assumes equal frequencies
    R, mu = _rates_tn93(pi, a1=5.0, a2=5.0, b=1.0)
    p1, p2, q = _expected_props(pi, R, mu, t)
    d = sm.k80(np.float64(p1 + p2), np.float64(q))
    assert d == pytest.approx(t, abs=1e-10)


def test_k80_hand_example():
    """Worked K80 example: P=0.1, Q=0.05 ->
    d = -1/2 ln(0.75) - 1/4 ln(0.90) (Kimura 1980 eq. 6)."""
    want = -0.5 * math.log(0.75) - 0.25 * math.log(0.90)
    assert sm.k80(np.float64(0.1), np.float64(0.05)) == pytest.approx(
        want, abs=1e-15)


# ------------------------------------------------------------------ #
# Scalar from-paper reimplementation (independent arithmetic)         #
# ------------------------------------------------------------------ #


def _oracle_k80(P, Q):
    return 0.5 * math.log(1.0 / (1.0 - 2.0 * P - Q)) + \
        0.25 * math.log(1.0 / (1.0 - 2.0 * Q))


def _oracle_f81(p, pi):
    B = 1.0 - (pi[0] ** 2 + pi[1] ** 2 + pi[2] ** 2 + pi[3] ** 2)
    return -B * math.log(1.0 - p / B)


def _oracle_f84(P, Q, pi):
    piA, piC, piG, piT = pi
    piR, piY = piA + piG, piC + piT
    a = piC * piT / piY + piA * piG / piR
    b = piC * piT + piA * piG
    c = piR * piY
    return (-2.0 * a * math.log(1.0 - P / (2.0 * a)
                                - (a - b) * Q / (2.0 * a * c))
            + 2.0 * (a - b - c) * math.log(1.0 - Q / (2.0 * c)))


def _oracle_tn93(P1, P2, Q, pi):
    piA, piC, piG, piT = pi
    piR, piY = piA + piG, piC + piT
    x1 = -(2.0 * piA * piG / piR) * math.log(
        1.0 - piR * P1 / (2.0 * piA * piG) - Q / (2.0 * piR))
    x2 = -(2.0 * piC * piT / piY) * math.log(
        1.0 - piY * P2 / (2.0 * piC * piT) - Q / (2.0 * piY))
    x3 = -2.0 * (piR * piY - piA * piG * piY / piR
                 - piC * piT * piR / piY) * math.log(
        1.0 - Q / (2.0 * piR * piY))
    return x1 + x2 + x3


def _rand_props(rng):
    """Non-degenerate (pi, P1, P2, Q) drawn inside every formula's
    domain (arguments of all logs positive)."""
    while True:
        pi = rng.dirichlet([5.0, 5.0, 5.0, 5.0])
        P1, P2 = rng.uniform(0.01, 0.08, 2)
        Q = rng.uniform(0.01, 0.08)
        try:
            _oracle_tn93(P1, P2, Q, pi)
            _oracle_f84(P1 + P2, Q, pi)
            _oracle_f81(P1 + P2 + Q, pi)
            _oracle_k80(P1 + P2, Q)
        except ValueError:
            continue
        return pi, P1, P2, Q


def test_scalar_oracle_agreement():
    rng = np.random.default_rng(0)
    for _ in range(25):
        pi, P1, P2, Q = _rand_props(rng)
        piv = np.asarray(pi)
        assert sm.k80(np.float64(P1 + P2), np.float64(Q)) == pytest.approx(
            _oracle_k80(P1 + P2, Q), abs=1e-12)
        assert sm.f81(np.float64(P1 + P2 + Q), piv) == pytest.approx(
            _oracle_f81(P1 + P2 + Q, pi), abs=1e-12)
        assert sm.f84(np.float64(P1 + P2), np.float64(Q), piv) == \
            pytest.approx(_oracle_f84(P1 + P2, Q, pi), abs=1e-12)
        assert sm.tn93(np.float64(P1), np.float64(P2), np.float64(Q), piv) \
            == pytest.approx(_oracle_tn93(P1, P2, Q, pi), abs=1e-12)


def test_degenerate_compositions_vanish():
    """Compositions concentrated on one base (E -> 0 class factors)
    give vanishing class terms, not NaN (submodels._sdiv limits)."""
    pi = np.array([1.0, 0.0, 0.0, 0.0])
    assert sm.f81(np.float64(0.0), pi) == 0.0
    assert np.isfinite(sm.tn93(np.float64(0.0), np.float64(0.0),
                               np.float64(0.0), pi))


def test_mutation_is_caught():
    """Sensitivity proof: a sign flip in f84's transversion term (the
    kind of slip the reductions-only tests missed) breaks the
    generative inversion by far more than its tolerance."""
    pi = PIS[1]
    R, mu = _rates_f84(pi, kappa=1.5, b=1.0)
    p1, p2, q = _expected_props(pi, R, mu, 0.3)

    def f84_flipped(Pp, Q, piv):
        piA, piC, piG, piT = (piv[..., i] for i in range(4))
        piR, piY = piA + piG, piC + piT
        a = piC * piT / piY + piA * piG / piR
        b = piC * piT + piA * piG
        c = piR * piY
        return (-2 * a * np.log(1 - Pp / (2 * a) - (a - b) * Q / (2 * a * c))
                - 2 * (a - b - c) * np.log(1 - Q / (2 * c)))  # sign flip

    good = sm.f84(np.float64(p1 + p2), np.float64(q), pi)
    bad = f84_flipped(np.float64(p1 + p2), np.float64(q), pi)
    assert good == pytest.approx(0.3, abs=1e-10)
    assert abs(bad - 0.3) > 1e-3
