#!/usr/bin/env python
"""Quickstart: synthesize genotype-likelihood data, estimate the
distance matrix three ways, and use the popgen toolkit.

Run from the repo root:  python examples/quickstart.py
"""

import gzip
import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from ngsdist_jax import Params, run  # noqa: E402

N_IND, N_SITES = 12, 2000
rng = np.random.default_rng(42)

with tempfile.TemporaryDirectory() as td:
    # Synthetic normal-space genotype posteriors, gzipped TSV.
    gp = rng.dirichlet(np.ones(3) * 4, size=(N_SITES, N_IND))
    geno = os.path.join(td, "gp.geno.gz")
    with gzip.open(geno, "wt") as fh:
        for s in range(N_SITES):
            fh.write("\t".join(f"{x:.6f}" for x in gp[s].reshape(-1)) + "\n")

    # 1) Full EM estimator with 10 block-bootstrap replicates.
    pars = Params(in_geno=geno, in_probs=True, n_ind=N_IND, n_sites=N_SITES,
                  out=os.path.join(td, "em.dist"), seed=1, n_boot_rep=10,
                  boot_block_size=20, verbose=0)
    mats = run(pars)
    print(f"EM estimator: {len(mats)} matrices, d[0,1]={mats[0][0,1]:.6f}")

    # 2) Fast independent-genotypes path with pairwise deletion + JC69.
    pars = Params(in_geno=geno, in_probs=True, indep_geno=True,
                  pairwise_del=True, evol_model=2, n_ind=N_IND,
                  n_sites=N_SITES, out=os.path.join(td, "jc.dist"),
                  seed=1, verbose=0)
    mats = run(pars)
    print(f"indep + JC69: d[0,1]={mats[0][0,1]:.6f}")

    # 3) Beyond-reference: TN93 distances (the reference CLI aborts on
    #    --evol_model 6) from a POS file with alleles, sharded over all
    #    local devices.
    bases = "ACGT"
    pos = os.path.join(td, "pos.txt")
    with open(pos, "w") as fh:
        for s in range(N_SITES):
            b = rng.choice(4, size=2, replace=False)
            fh.write(f"chr1\t{s+1}\t{bases[b[0]]}\t{bases[b[1]]}\n")
    from ngsdist_jax.parallel import make_mesh

    pars = Params(in_geno=geno, in_probs=True, indep_geno=True, evol_model=6,
                  in_pos=pos, n_ind=N_IND, n_sites=N_SITES,
                  out=os.path.join(td, "tn93.dist"), seed=1, verbose=0)
    mats = run(pars, mesh=make_mesh())
    print(f"TN93 (sharded): d[0,1]={mats[0][0,1]:.6f}")

    # 4) popgen toolkit: per-site MAFs from the same GLs.
    import jax.numpy as jnp

    from ngsdist_jax import popgen
    from ngsdist_jax.io import readers

    GL = readers.read_geno(geno, False, True, False, N_IND, N_SITES)
    mafs = popgen.est_maf_sites(jnp.asarray(GL))
    print(f"MAFs: mean={float(mafs.mean()):.4f} "
          f"first5={np.asarray(mafs[:5]).round(3)}")

    # 5) popgen toolkit: inbreeding-tract decoding with the distance HMM
    #    (2 states: outbred F=0 vs inbred F=1, exponential-decay
    #    transitions over the inter-site distances from the POS file).
    pos_dist = readers.read_pos_dist(
        readers.read_pos(pos, False, N_SITES), N_SITES)
    gl0 = jnp.asarray(GL[:, 0])  # individual 0, log-scale GLs
    e_prob = jnp.stack(
        [popgen.calc_emission(gl0, mafs, jnp.asarray(f)) for f in (0.0, 1.0)],
        axis=-1,
    )
    q_prop = jnp.asarray([0.9, 0.1])
    path, score = popgen.viterbi(
        q_prop, jnp.asarray(1e-4), e_prob, jnp.asarray(pos_dist)
    )
    print(f"HMM Viterbi: {int(np.asarray(path).sum())} inbred sites "
          f"of {N_SITES} (log score {float(score):.1f})")
print("quickstart OK")
