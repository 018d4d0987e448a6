"""Bit-exact CPU pairwise-distance path (parity oracle).

Thin wrapper over the native engine (ngsdist_native.c: nd_pair_dists),
which accumulates per pair in the reference's exact operation order
(/root/reference/ngsDist.cpp:325-404) with glibc transcendentals, so the
formatted output is md5-identical to a reference run.  The JAX engine in
core/distance.py is the performance path; tests pin it against this one.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..utils import native as _native


def to_ind_major(P_site_major: np.ndarray) -> np.ndarray:
    """[n_sites, n_ind, 3] -> contiguous [n_ind, n_sites, 3] for the
    pair-loop engine's cache behavior."""
    return np.ascontiguousarray(P_site_major.transpose(1, 0, 2))


def pair_dists_exact(
    P_ind_major: np.ndarray,
    score: np.ndarray,
    indep: bool,
    pairwise_del: bool,
    tot_sites: int,
    evol_model: int,
    n_threads: int = 1,
    site_map: Optional[np.ndarray] = None,
    n_used: Optional[int] = None,
    want_stats: bool = False,
):
    """Full symmetric [n_ind, n_ind] distance matrix (diagonal 0).

    site_map (int64, destination order) selects/repeats source sites for
    bootstrap replicates; n_used limits the site count (truncation).
    want_stats additionally returns the pre-correction raw sums and
    valid-site counts (reference verbose>=3 report, ngsDist.cpp:366-367)
    as (out, raw, cnt).
    """
    n_ind, n_sites, _ = P_ind_major.shape
    if n_used is None:
        n_used = n_sites if site_map is None else len(site_map)
    lib = _native.get_lib()
    out = np.zeros((n_ind, n_ind), dtype=np.float64)
    score64 = np.ascontiguousarray(score, dtype=np.float64)
    map_ptr = None
    if site_map is not None:
        site_map = np.ascontiguousarray(site_map, dtype=np.int64)
        map_ptr = _native.as_i64_ptr(site_map)
    raw = cnt = None
    raw_ptr = cnt_ptr = None
    if want_stats:
        raw = np.zeros((n_ind, n_ind), dtype=np.float64)
        cnt = np.zeros((n_ind, n_ind), dtype=np.float64)
        raw_ptr = _native.as_double_ptr(raw)
        cnt_ptr = _native.as_double_ptr(cnt)
    rc = lib.nd_pair_dists(
        _native.as_double_ptr(P_ind_major), n_ind, n_sites,
        map_ptr, n_used,
        _native.as_double_ptr(score64.reshape(-1)),
        int(indep), int(pairwise_del), tot_sites, evol_model, n_threads,
        _native.as_double_ptr(out), raw_ptr, cnt_ptr,
    )
    if rc == 2:
        # Reference aborts inside the first pair task (ngsDist.cpp:387-398).
        from .models import check_model_supported

        check_model_supported(evol_model)
    if want_stats:
        return out, raw, cnt
    return out


def debug_site_dump(
    P_ind_major: np.ndarray,
    score: np.ndarray,
    indep: bool,
    pairwise_del: bool,
    labels,
    verbose: int,
    site_map: Optional[np.ndarray] = None,
    n_used: Optional[int] = None,
    fh=None,
) -> None:
    """Per-site debug firehose of the reference hot loop at verbose>=8:
    the cumulative-distance line per (pair, site) and, at verbose>=9,
    the per-genotype-combination terms (ngsDist.cpp:355-360).  Python
    reproduces the C accumulation order exactly (C doubles), with the
    per-site EM delegated to the native nd_em2_site, so the printed
    values match the reference character-for-character."""
    import sys

    fh = fh if fh is not None else sys.stderr
    lib = _native.get_lib()
    n_ind, n_sites, _ = P_ind_major.shape
    if n_used is None:
        n_used = n_sites if site_map is None else len(site_map)
    sites = site_map if site_map is not None else np.arange(n_used)
    P = P_ind_major
    uniform = np.full(9, 1.0 / 9.0)

    def miss(p):  # miss_data (gen_func.cpp:862-868)
        return abs(p[0] - p[1]) < 1e-5 and abs(p[1] - p[2]) < 1e-5

    for i1 in range(n_ind):
        for i2 in range(i1 + 1, n_ind):
            dist = 0.0
            cnt = 0
            for t in range(n_used):
                s = int(sites[t])
                p1 = P[i1, s]
                p2 = P[i2, s]
                if pairwise_del and (miss(p1) or miss(p2)):
                    continue
                sfs = uniform.copy()
                if not indep:
                    lib.nd_em2_site_run(
                        _native.as_double_ptr(sfs),
                        _native.as_double_ptr(np.ascontiguousarray(p1)),
                        _native.as_double_ptr(np.ascontiguousarray(p2)),
                    )
                for g1 in range(3):
                    for g2 in range(3):
                        w = p1[g1] * p2[g2]
                        dist += score[g1, g2] * (w if indep else sfs[3 * g1 + g2])
                        if verbose >= 9:
                            # ngsDist.cpp:355-356 ("%lu\t%lu <-> %lu\t...")
                            fh.write(
                                f"{t}\t{i1} <-> {i2}\t{g1} - {g2}\t"
                                f"{w:f}\t{sfs[3 * g1 + g2]:f}\n"
                            )
                if verbose >= 8:
                    # ngsDist.cpp:359-360
                    fh.write(
                        f"Cumulative distance between {labels[i1]} (ind {i1}) "
                        f"and {labels[i2]} (ind {i2}) at site {t}: {dist:f}\n"
                    )
                cnt += 1
            if verbose >= 3:
                # the pair's stats line interleaves with its site dump
                # exactly as in the reference worker (ngsDist.cpp:366-367)
                fh.write(
                    f"\tDistance of {dist:f} from {cnt} valid sites "
                    f"({dist / cnt if cnt else float('nan'):f}) between "
                    f"{labels[i1]} (ind {i1}) and {labels[i2]} (ind {i2})!\n"
                )
