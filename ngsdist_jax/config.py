"""Run configuration for ngsdist_jax.

`Params` mirrors the reference's flat params struct and flag surface
(/root/reference/ngsDist.hpp:11-44, parse_args.cpp:6-221) so existing
ngsDist pipelines can switch over without changes, including the
implication rules (--log_scale implies --probs; thresholds imply
--call_geno; genotype input or genotype calling forces --indep_geno;
non-gz file input is treated as binary and forces --probs) and the
validation errors, in the reference's order.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

N_GENO = 3

EVOL_MODEL_NAMES = [
    "Raw p-distance",
    "Log transf. p-distance",
    "JC69",
    "K80",
    "F81",
    "HKY85/F84",
    "TN93",
]


class NgsDistError(RuntimeError):
    """Fatal configuration / data error (reference exits -1 on these).

    err carries the OS errno at the failure point: the reference's
    error() helper ends with perror("\\t") (gen_func.cpp:12-18), so the
    CLI prints "\\t: <strerror(err)>" after the ERROR block ("Success"
    when no syscall failed)."""

    def __init__(self, func: str, msg: str, err: int = 0):
        super().__init__(f"[{func}] {msg}")
        self.func = func
        self.msg = msg
        self.err = err


def default_score_matrix(avg_nuc_dist: bool = False) -> np.ndarray:
    """3x3 genotype-combination distance weights.

    Gronau et al. 2011 (eq 12) / Freedman et al. 2014 (eq 8.1); with
    avg_nuc_dist, het-het pairs score 0.5 (Freedman eq 8.2).  Reference:
    parse_args.cpp:22-27,134-137.
    """
    score = np.array(
        [[0.0, 0.5, 1.0], [0.5, 0.0, 0.5], [1.0, 0.5, 0.0]], dtype=np.float64
    )
    if avg_nuc_dist:
        score[1, 1] = 0.5
    return score


@dataclass
class Params:
    in_geno: Optional[str] = None
    in_bin: bool = False
    in_probs: bool = False
    in_logscale: bool = False
    n_ind: int = 0
    n_sites: int = 0
    tot_sites: int = 0
    in_labels: Optional[str] = None
    in_labels_header: bool = False
    in_pos: Optional[str] = None
    in_pos_header: bool = False
    call_geno: bool = False
    N_thresh: float = 0.0
    call_thresh: float = 0.0
    pairwise_del: bool = False
    avg_nuc_dist: bool = False
    evol_model: int = 1
    indep_geno: bool = False
    n_boot_rep: int = 0
    boot_block_size: int = 1
    out: Optional[str] = None
    n_threads: int = 1
    verbose: int = 1
    seed: Optional[int] = None

    # Messages emitted by finalize() (stage banners the reference prints
    # unconditionally or at verbose>=1); the CLI relays them to stderr.
    messages: List[str] = field(default_factory=list)

    def __post_init__(self):
        if self.seed is None:
            # Reference default: time(NULL) (parse_args.cpp:35).
            self.seed = int(time.time())

    @property
    def score(self) -> np.ndarray:
        return default_score_matrix(self.avg_nuc_dist)

    @property
    def n_comb(self) -> int:
        return (self.n_ind * self.n_ind - self.n_ind) // 2

    def validate(self) -> None:
        """Argument checks in the reference's order (parse_args.cpp:200-220)."""
        if self.in_geno is None:
            raise NgsDistError("parse_cmd_args", "genotype input file (--geno) missing!")
        if self.n_ind == 0:
            raise NgsDistError("parse_cmd_args", "number of individuals (--n_ind) missing!")
        if self.n_sites == 0:
            raise NgsDistError("parse_cmd_args", "number of sites (--n_sites) missing!")
        if self.tot_sites > 0 and self.pairwise_del:
            raise NgsDistError(
                "parse_cmd_args",
                "cannot specify total number of sites (--tot_sites) with pairwise deletion (--pairwise_del)!",
            )
        if self.call_geno and not self.in_probs:
            raise NgsDistError(
                "parse_cmd_args", "can only call genotypes from likelihoods/probabilities!"
            )
        if self.evol_model < 0 or self.evol_model > 6:
            raise NgsDistError("parse_cmd_args", "invalid correction method specified!")
        if self.evol_model > 2 and self.in_pos is None:
            raise NgsDistError(
                "parse_cmd_args",
                "use of more complex evolutionary models requires position information!",
            )
        if self.out is None:
            raise NgsDistError("parse_cmd_args", "output prefix (--out) missing!")
        if self.n_threads < 1:
            raise NgsDistError("parse_cmd_args", "number of threads cannot be less than 1!")
        # Beyond-reference guards (checked AFTER the reference's own
        # validation order): the reference loops effectively forever on
        # a negative replicate count (uint64 wraparound of the rep loop
        # bound, ngsDist.cpp:217) and hits n_sites % 0 on a zero block
        # size (ngsDist.cpp:236) — clean fatals instead.
        if self.n_boot_rep < 0:
            raise NgsDistError(
                "parse_cmd_args", "number of bootstrap replicates cannot be negative!"
            )
        if self.boot_block_size < 1:
            raise NgsDistError(
                "parse_cmd_args", "bootstrap block size cannot be less than 1!"
            )

    def finalize(self) -> None:
        """Post-parse adjustments in the reference's order (ngsDist.cpp:44-94).

        Order matters: the genotype-input fast-path check runs BEFORE the
        binary sniffing that forces in_probs, so a binary file given
        without --probs still auto-enables --indep_geno.
        """
        self.messages = []
        n_comb = self.n_comb
        if self.verbose >= 1:
            self.messages.append(f"==> Analysis will be run in {n_comb} combinations")
        if n_comb < self.n_threads:
            if self.verbose >= 1:
                self.messages.append(
                    f"==> Fewer combinations ({n_comb}) than threads ({self.n_threads}). "
                    "Reducing the number of threads..."
                )
            self.n_threads = n_comb

        if not self.in_probs and not self.indep_geno:
            self.messages.append(
                "==> Using faster algorithm (assuming independence of genotypes) since input are genotypes!"
            )
            self.indep_geno = True
        elif self.call_geno and not self.indep_geno:
            self.messages.append(
                "==> Using faster algorithm (assuming independence of genotypes) since calling genotypes!"
            )
            self.indep_geno = True
        elif self.indep_geno and self.verbose >= 1:
            self.messages.append(
                "==> Using faster algorithm (assuming independence of genotypes)!"
            )

        if self.in_geno == "-":
            if self.verbose >= 1:
                self.messages.append("==> Reading from STDIN (BINARY)")
            self.in_bin = True
        else:
            try:
                st_size = os.stat(self.in_geno).st_size
            except OSError as ex:
                raise NgsDistError("main", "cannot check GENO file size!",
                                   err=ex.errno or 0)
            if self.in_geno.endswith(".gz"):
                if self.verbose >= 1:
                    self.messages.append("==> GZIP input file (never BINARY)")
                self.in_bin = False
            else:
                if self.verbose >= 1:
                    self.messages.append("==> BINARY input file")
                self.in_bin = True
                self.in_probs = True
                if self.n_sites != st_size // 8 // self.n_ind // N_GENO:
                    raise NgsDistError("main", "invalid/corrupt genotype input file!")
