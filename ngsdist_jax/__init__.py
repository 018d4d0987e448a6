"""ngsdist_jax — a JAX genetic-distance engine.

Estimates pairwise genetic distance matrices between individuals from
genotypes, genotype likelihoods or posterior probabilities without
calling genotypes, with hard-call thresholds, pairwise deletion,
p-distance/JC69 corrections and fixed-seed block-bootstrap replicates —
the capability surface of fgvieira/ngsDist, re-designed for accelerators:

  - probability tensors [n_sites, n_ind, 3] sharded site-parallel over a
    jax Mesh; all n_ind^2/2 pairs computed as one batched contraction
    (core/distance.py) with a Pallas kernel for the pairwise-EM path
    on GPUs (ops/em_kernel.py);
  - block bootstrap as host-side taus index tables reusing per-block
    partial pair sums (core/bootstrap.py);
  - a native C host runtime for exact readers and a bit-exact CPU parity
    engine (native/, core/exact.py);
  - an ngsDist-compatible CLI (cli.py, `python -m ngsdist_jax`).
"""

from .config import Params, NgsDistError, default_score_matrix, EVOL_MODEL_NAMES
from .runner import run
from .version import __version__

__all__ = [
    "Params",
    "NgsDistError",
    "default_score_matrix",
    "EVOL_MODEL_NAMES",
    "run",
    "__version__",
]
