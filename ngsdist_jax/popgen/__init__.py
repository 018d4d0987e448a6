"""JAX popgen toolkit.

The reference's shared/ directory carries library components used by
sibling ngsTools projects but not linked into ngsDist itself
(SURVEY.md §2.2): an inbreeding/IBD HMM engine, per-site allele-
frequency EM, two-site haplotype-frequency EM, and a bounded
quasi-Newton optimizer.  This subpackage provides the same capability
surface as batched, jit-compatible JAX code: the per-chain/per-site
loops become `lax.scan`/`lax.while_loop` with vmap over chains or
sites, so thousands of HMM chains or EM problems run as one device
computation.
"""

from .freqs import calc_hwe, est_maf, est_maf_sites, haplo_freq  # noqa: F401
from .hmm import (  # noqa: F401
    calc_emission,
    calc_emission_ld,
    calc_emission_two_mafs,
    joint_geno_prob,
    forward,
    backward,
    posterior_decode,
    transition_matrices,
    viterbi,
)
from .optim import lbfgsb  # noqa: F401
