"""End-to-end orchestration: config -> read -> preprocess -> distances -> output.

The JAX equivalent of the reference driver main()
(/root/reference/ngsDist.cpp:29-320).  Where the reference enqueues one
thread-pool task per individual pair per replicate, this driver hands the
whole normal-space probability tensor to an engine that computes every
pair at once:

  - engine="exact": native CPU engine, bit-identical output (parity oracle)
  - engine="jax":   batched XLA/Pallas engine (single chip or sharded mesh)
  - engine="auto":  jax if importable, else exact
"""

from __future__ import annotations

import os
import sys
from typing import List, Optional, TextIO

import numpy as np

from .config import Params, NgsDistError
from .core import bootstrap as bt
from .core import exact as exact_engine
from .core import models
from .core.preprocess import preprocess
from .io import readers, writers


def _log(pars: Params, level: int, msg: str) -> None:
    if pars.verbose >= level:
        print(msg, file=sys.stderr)


def _fused_packed_wanted(pars: Params, engine: str, mesh) -> bool:
    """True when the genotype read should be DEFERRED to the engine as
    a fused-read handle (readers.PackedBinInput): the engine then pulls
    upload-ready packed f32 chunks straight from disk — one native pass
    instead of read+exp+pack over a resident f64 tensor, with chunk
    reads overlapping the async device upload.  Requires the f32
    2-component upload path and an engine stage that never needs the
    host tensor (models 0-2, no genotype calling, no per-site debug
    replay).  NGSDIST_FUSED_READ=0 forces the staged pipeline."""
    if engine != "jax" or mesh is not None:
        return False
    if os.environ.get("NGSDIST_FUSED_READ", "auto") == "0":
        return False
    if not pars.in_bin or not readers.is_raw_seekable_binary(pars.in_geno):
        return False  # fused readers need a raw regular file (magic sniff)
    if pars.call_geno or pars.evol_model >= 3 or pars.verbose >= 8:
        return False
    from .utils import native as _native

    if not _native.have_native():
        return False
    import jax.numpy as jnp

    from .core.distance import default_dtype
    from .utils.hostmem import upload23_enabled

    return (default_dtype() == jnp.float32
            and upload23_enabled(np.float32))


def _fused_coded_wanted(pars: Params, engine: str, mesh):
    """Route for the fused native CODES reader (readers.read_geno_codes):
    raw binary GP under DEFAULT-THRESHOLD --call_geno hard-calls every
    triple to a one-hot or the uniform missing value, so ONE native
    pass yields the uint8 code plane (1 byte/triple) and the staged
    read -> call_geno -> exp -> derive_codes chain (four full passes, a
    24-bytes/triple resident tensor) never runs.  Returns:

    - "handle" — defer reads to a readers.CodedBinInput: the engine
      pulls code chunks on demand, overlapping disk reads with the
      in-flight device copy, and NO plane is ever host-resident (also
      supersedes the lazy stream at any size).  Single-device runs.
    - "eager"  — read the resident code plane up front (mesh runs shard
      it via SiteStream.from_array; also chunked+bootstrap runs, where
      a resident plane avoids per-replicate disk re-reads).
    - False    — staged pipeline (gates mirror the staged coded-upload
      block: models 0-2, verbose < 8, f32 coded uploads on;
      NGSDIST_FUSED_READ=0 forces staged; over-host-budget mesh runs
      fall through to LAZY coded rounds instead)."""
    if engine != "jax":
        return False
    if not pars.in_bin or not readers.is_raw_seekable_binary(pars.in_geno):
        return False  # fused readers need a raw regular file (magic sniff)
    import jax.numpy as jnp

    from .core.distance import default_dtype
    from .parallel.multihost import SiteStream

    if (default_dtype() != jnp.float32
            or not SiteStream.coded_call_eligible(pars, np.float32)):
        return False
    from .core.distance import _device_budget_bytes

    plane_fits = (pars.n_sites * pars.n_ind * 2
                  <= SiteStream._host_budget_bytes())
    if mesh is not None:
        # sharded runs need the plane (or lazy coded rounds, their own
        # gate) — global codes + the local shard copy ~ 2 bytes/triple
        return "eager" if plane_fits else False
    if _lazy_stream_wanted(pars, engine):
        import jax

        if len(jax.devices()) > 1:
            # a lazy run auto-meshes over ALL local devices
            # (run(): make_mesh) — a single-device handle would trade
            # that N-way sharded compute for overlap; take LAZY CODED
            # rounds on the mesh instead
            return False
    chunked = pars.n_sites * pars.n_ind * 3 * 4 > _device_budget_bytes()
    if chunked and pars.n_boot_rep and plane_fits:
        # chunked bootstrap re-reads every chunk per replicate through
        # a handle; a resident plane slices from RAM instead
        return "eager"
    return "handle"


def load_inputs(pars: Params, geno: bool = True, fused: bool = False,
                coded: bool = False):
    """Read labels, positions and the genotype tensor; returns
    (labels, pos_rows, P_normal [n_sites, n_ind, 3]).

    geno=False skips the genotype read (P is None) — the lazy
    disk-streaming path constructs a SiteStream instead.
    fused=True returns a readers.PackedBinInput handle instead of the
    tensor (the engine reads fused packed chunks on demand)."""
    if pars.in_labels:
        _log(pars, 1, "==> Reading labels")
        labels = readers.read_labels(pars.in_labels, pars.in_labels_header, pars.n_ind)
    else:
        labels = readers.default_labels(pars.n_ind)
    if pars.verbose >= 4:
        for lbl in labels:
            print(lbl, file=sys.stderr)

    pos_rows = None
    if pars.in_pos:
        _log(pars, 1, "==> Reading positions file")
        pos_rows = readers.read_pos(pars.in_pos, pars.in_pos_header, pars.n_sites)
        if pars.verbose >= 4:
            for row in pos_rows:
                print("\t".join((row + ["", "", "", ""])[:4]), file=sys.stderr)

    if not geno:
        return labels, pos_rows, None
    _log(pars, 1, "==> Reading genotype data")
    if fused:
        return labels, pos_rows, readers.PackedBinInput(pars)
    if coded == "handle":
        return labels, pos_rows, readers.CodedBinInput(pars)
    if coded:  # "eager": resident code plane
        got = readers.read_geno_codes(
            pars.in_geno, pars.in_logscale, pars.n_ind, pars.n_sites)
        if got is not None:
            from .utils.hostmem import CodedProbs, coded_call_lut

            codes, any_missing = got
            return labels, pos_rows, CodedProbs(
                None, codes, coded_call_lut(any_missing))
        # not raw seekable binary after all (TOCTOU): staged read below
    geno_log = readers.read_geno(
        pars.in_geno, pars.in_bin, pars.in_probs, pars.in_logscale,
        pars.n_ind, pars.n_sites,
    )
    P = preprocess(geno_log, pars.call_geno, pars.N_thresh, pars.call_thresh)
    return labels, pos_rows, P


def _lazy_stream_wanted(pars: Params, engine: str) -> bool:
    """True when eagerly loading the genotype tensor would exceed the
    host-RAM budget and the input supports per-round disk reads: the
    jax engine then streams rounds from disk via a lazy SiteStream, so
    host RAM no longer bounds genome length (the reference's only
    capacity bound, read_data.cpp:21).  The eligibility predicate and
    byte estimate live on SiteStream (wants_lazy) so the runner and
    from_reader can never disagree."""
    if engine != "jax":
        return False
    from .core.distance import default_dtype
    from .parallel.multihost import SiteStream

    import jax.numpy as jnp

    np_dtype = np.float64 if default_dtype() == jnp.float64 else np.float32
    return SiteStream.wants_lazy(pars, np_dtype, pars.n_sites)


def make_pair_report(pars: Params, labels):
    """verbose>=3 per-pair stats line (ngsDist.cpp:366-367): raw distance
    sum, valid-site count and their ratio, before model correction."""
    if pars.verbose < 3:
        return None

    def on_stats(raw, denom):
        d = np.asarray(denom)
        for i1 in range(pars.n_ind):
            for i2 in range(i1 + 1, pars.n_ind):
                cnt = d[i1, i2] if d.ndim == 2 else float(denom)
                avg = raw[i1, i2] / cnt if cnt else float("nan")
                print(
                    f"\tDistance of {raw[i1, i2]:f} from {int(cnt)} valid sites "
                    f"({avg:f}) between {labels[i1]} (ind {i1}) and "
                    f"{labels[i2]} (ind {i2})!",
                    file=sys.stderr,
                )

    return on_stats


def resolve_engine(engine: str) -> str:
    """Resolve 'auto' to a concrete engine: jax when importable, exact
    otherwise.  Behavior gated on the engine (e.g. whether models 3-6
    reproduce the reference abort) must use the resolved name."""
    if engine != "auto":
        return engine
    try:
        from .core import distance as _  # noqa: F401

        return "jax"
    except Exception:
        return "exact"


def iter_replicates(pars: Params, P: np.ndarray, engine: str = "auto", mesh=None,
                    on_stats=None, alleles=None, labels=None,
                    start_rep: int = 0, round_ckpt: bool = False):
    """Yield the distance matrices for replicates start_rep..n_boot_rep
    (streamed so output durability matches the reference, which prints
    each matrix as its replicate completes, ngsDist.cpp:282-287).

    start_rep > 0 resumes an interrupted run: earlier replicates are
    not computed at all (the bootstrap index table is a pure function
    of the seed, so later replicates are unaffected).
    labels: individual names for the exact engine's verbose>=8 per-site
    debug dump (reference firehose, ngsDist.cpp:355-360)."""
    engine = resolve_engine(engine)

    # Models 3-6 abort inside the first pair task in the reference
    # (ngsDist.cpp:387-398) — AFTER the replicate's stage banners.  The
    # exact engine reproduces that abort (native rc=2 raises inside the
    # loop below, post-banner); the jax engine implements the models
    # (core/submodels.py) from the POS file's alleles.
    if pars.evol_model < 3:
        models.check_model_supported(pars.evol_model)
    elif engine == "jax" and alleles is None:
        raise NgsDistError(
            "main", "evolutionary models need allele info in the POS file!"
        )

    _log(pars, 2, "==> Setting seed for random number generator")
    n_trunc, maps = bt.site_maps(
        pars.seed, pars.n_boot_rep, pars.n_sites, pars.boot_block_size
    )

    def dump_block_map(rep: int) -> None:
        # bootstrap block-mapping dump at verbose>=5, emitted during the
        # replicate's mapping phase like rnd_map_data (ngsDist.cpp:430-431)
        if pars.verbose < 5 or rep == 0:
            return
        bs = pars.boot_block_size
        site_map = maps[rep - 1]
        for block in range(len(site_map) // bs):
            for s_off in range(bs):
                dest = block * bs + s_off
                src = int(site_map[dest])
                print(
                    f"block: {block}	orig_site: {dest}	"
                    f"rand_block:{src // bs}	rand_site: {src}",
                    file=sys.stderr,
                )

    if engine == "exact":
        P_ind = exact_engine.to_ind_major(P)
        dump_labels = labels if labels is not None else readers.default_labels(pars.n_ind)
        for rep in range(start_rep, pars.n_boot_rep + 1):
            _log(pars, 1, "==> Analyzing full dataset..." if rep == 0
                 else f"==> Bootstrap replicate # {rep} ...")
            _log(pars, 2, "> Mapping positions...")
            dump_block_map(rep)
            _log(pars, 2, "> Calculating pairwise genetic distances...")
            site_map = None if rep == 0 else maps[rep - 1]
            n_used = pars.n_sites if rep == 0 else n_trunc
            if pars.verbose >= 8:
                # Per-site firehose prints the v9/v8/v3 lines interleaved
                # per pair exactly as the reference worker does.
                exact_engine.debug_site_dump(
                    P_ind, pars.score, pars.indep_geno, pars.pairwise_del,
                    dump_labels, pars.verbose, site_map=site_map, n_used=n_used,
                )
                yield exact_engine.pair_dists_exact(
                    P_ind, pars.score, pars.indep_geno, pars.pairwise_del,
                    pars.tot_sites, pars.evol_model, pars.n_threads,
                    site_map=site_map, n_used=n_used,
                )
            else:
                out, raw, cnt = exact_engine.pair_dists_exact(
                    P_ind, pars.score, pars.indep_geno, pars.pairwise_del,
                    pars.tot_sites, pars.evol_model, pars.n_threads,
                    site_map=site_map, n_used=n_used, want_stats=True,
                )
                if on_stats is not None:
                    on_stats(raw, cnt)
                yield out
    elif engine == "jax":
        from .core import distance as jax_engine

        # verbose>=8 firehose: the reference prints the per-site dump
        # from its only engine (ngsDist.cpp:355-360).  The jax engine
        # computes whole replicates at once, so the dump is replayed
        # per-site by the exact engine's host-side replayer — matrices
        # in the OUTPUT still come from the jax engine (the replay's
        # exact-engine accumulation can differ from the jax matrices in
        # the last bits; docs/PARITY.md).  Lazy disk-streamed runs have
        # no resident tensor to replay — warn instead of dumping.
        dump_P_ind = None
        if pars.verbose >= 8:
            if isinstance(P, np.ndarray):
                dump_P_ind = exact_engine.to_ind_major(P)
            else:
                print("WARN: [main] verbose>=8 per-site dump unavailable "
                      "on disk-streamed (lazy) runs; rerun with a larger "
                      "NGSDIST_HOST_BUDGET or --engine exact.",
                      file=sys.stderr)
        dump_labels = labels if labels is not None else readers.default_labels(pars.n_ind)

        # Stage banners per replicate (reference ngsDist.cpp:223-242):
        # printed before each matrix is pulled, so their timing brackets
        # the replicate's computation like the reference's.
        gen = jax_engine.iter_replicates(
            pars, P, maps, n_trunc, mesh=mesh, on_stats=on_stats,
            alleles=alleles, start_rep=start_rep, round_ckpt=round_ckpt,
        )
        for rep in range(start_rep, pars.n_boot_rep + 1):
            _log(pars, 1, "==> Analyzing full dataset..." if rep == 0
                 else f"==> Bootstrap replicate # {rep} ...")
            _log(pars, 2, "> Mapping positions...")
            dump_block_map(rep)
            _log(pars, 2, "> Calculating pairwise genetic distances...")
            if dump_P_ind is not None:
                exact_engine.debug_site_dump(
                    dump_P_ind, pars.score, pars.indep_geno,
                    pars.pairwise_del, dump_labels, pars.verbose,
                    site_map=None if rep == 0 else maps[rep - 1],
                    n_used=pars.n_sites if rep == 0 else n_trunc,
                )
            try:
                yield next(gen)
            except StopIteration:
                return
    else:
        raise ValueError(f"unknown engine: {engine}")


def run(
    pars: Params,
    engine: str = "auto",
    out_fh: Optional[TextIO] = None,
    mesh=None,
    resume: bool = False,
    trace_dir: Optional[str] = None,
    report_throughput: bool = False,
) -> List[np.ndarray]:
    """Full pipeline; writes matrices to pars.out (or out_fh) and returns them.

    mesh: optional jax.sharding.Mesh — shards the site axis across its
    devices (jax engine only).
    resume: continue an interrupted run from its .ckpt.json sidecar
    (matrices already durable in the output file are skipped).
    trace_dir: capture a jax.profiler trace of the compute section.
    report_throughput: print pair-site updates/sec to stderr at the end.
    """
    from .utils import checkpoint as ckpt
    from .utils import signals
    from .utils.profiling import Throughput, trace

    pars.validate()
    # The compile cache probe touches the jax backend — only AFTER
    # validation, so a bad invocation errors without any device work
    # (reference order: parse/validation fatals precede everything).
    if resolve_engine(engine) == "jax":
        from .utils import compile_cache

        compile_cache.enable()

    try:
        pars.finalize()
    finally:
        # the reference prints its stage banners as it goes, so the
        # ones accumulated before a finalize-time fatal (bad file size,
        # missing input) must still reach stderr in order
        for msg in pars.messages:
            print(msg, file=sys.stderr)

    engine = resolve_engine(engine)
    coded = _fused_coded_wanted(pars, engine, mesh)
    lazy = not coded and _lazy_stream_wanted(pars, engine)
    fused = not lazy and not coded and _fused_packed_wanted(pars, engine, mesh)
    labels, pos_rows, P = load_inputs(pars, geno=not lazy, fused=fused,
                                      coded=coded)
    if lazy:
        from .core.distance import default_dtype
        from .parallel.mesh import make_mesh
        from .parallel.multihost import SiteStream

        import jax.numpy as jnp

        _log(pars, 1, "==> Reading genotype data")  # read happens per round
        if mesh is None:
            mesh = make_mesh()  # all local devices
        np_dtype = np.float64 if default_dtype() == jnp.float64 else np.float32
        P = SiteStream.from_reader(pars, mesh, np_dtype)
    if (engine == "jax" and not lazy and not fused
            and pars.evol_model <= 2 and pars.verbose < 8
            and isinstance(P, np.ndarray)
            and (not pars.in_probs or pars.call_geno)):
        # Hard-genotype inputs (read_data.cpp:87-95) and --call_geno
        # runs produce tensors of one-hot/uniform triples: upload ONE
        # uint8 code per (site, ind) + a tiny table instead of the f32
        # slab — 8x fewer host-link bytes, expanded on device
        # (hostmem.derive_codes; the scan bails on the first
        # non-codeable chunk, e.g. thresholded call_geno that left
        # mid-confidence triples untouched).  Mesh runs shard the code
        # plane itself (SiteStream.from_array; the scan is
        # deterministic, so every process derives identical tables).
        import jax.numpy as jnp

        from .core.distance import default_dtype
        from .utils.hostmem import (CodedProbs, coded_upload_enabled,
                                    derive_codes)

        npdt = np.float64 if default_dtype() == jnp.float64 else np.float32
        if coded_upload_enabled(npdt):
            got = derive_codes(P)
            if got is not None:
                P = CodedProbs(P, *got)

    alleles = None
    if pars.evol_model >= 3 and pos_rows is not None and engine != "exact":
        from .core.submodels import encode_alleles

        alleles = encode_alleles(pos_rows)

    n_done = 0
    if resume and out_fh is None:
        got = ckpt.load(pars.out, pars, engine=engine)
        if got is not None:
            n_done = got
            _log(pars, 1, f"==> Resuming: {n_done} matrices already written")

    close = False
    if out_fh is None:
        try:
            out_fh = open(pars.out, "a" if n_done else "w")
        except OSError as ex:
            raise NgsDistError("main", "cannot open output file!",
                               err=ex.errno or 0)
        close = True
    matrices: List[np.ndarray] = []
    meter = Throughput(pars.n_comb)
    # True per-replicate update counts come through the stats hook (the
    # jax engine reports the pre-override valid-site counts); engines
    # that don't call it fall back to n_pairs * per-replicate sites.
    pending_updates: List[float] = []
    user_stats = make_pair_report(pars, labels)
    if engine == "jax" and pars.verbose >= 8 and not lazy:
        # the exact replayer (iter_replicates' firehose) prints the v3
        # pair-stats lines interleaved with the v8/v9 dump, like the
        # reference worker — a second print here would duplicate them
        user_stats = None

    def on_stats(raw, cnt):
        if isinstance(cnt, np.ndarray):
            iu = np.triu_indices(pars.n_ind, 1)
            pending_updates.append(float(np.sum(cnt[iu])))
        else:
            pending_updates.append(float(pars.n_comb) * float(cnt))
        if user_stats is not None:
            user_stats(raw, cnt)

    # Bootstrap replicates run over the block-truncated site count
    # (ngsDist.cpp:235-237).
    bs = pars.boot_block_size
    n_trunc = pars.n_sites - pars.n_sites % bs if pars.n_boot_rep else pars.n_sites
    interrupted = False
    try:
        with trace(trace_dir):
            for rep, m in enumerate(
                iter_replicates(pars, P, engine=engine, mesh=mesh,
                                on_stats=on_stats, alleles=alleles,
                                labels=labels, start_rep=n_done,
                                # round-level suffstats durability for
                                # streamed long-genome replicates
                                round_ckpt=close),
                start=n_done,  # durable replicates are never recomputed
            ):
                n_used = pars.n_sites if rep == 0 else n_trunc
                got = pending_updates.pop() if pending_updates else (
                    float(pars.n_comb) * float(n_used)
                )
                _log(pars, 2, "> Printing distance matrix")
                writers.write_dist_matrix(out_fh, labels, m)
                out_fh.flush()
                matrices.append(m)
                meter.add_updates(got)
                if close:
                    ckpt.save(pars.out, pars, rep + 1, engine=engine)
                if signals.stop_requested():
                    _log(pars, 1, "==> Stop requested; output is resumable (--resume)")
                    interrupted = True
                    break
    finally:
        if close:
            out_fh.close()
        if lazy:
            P.close()  # delete an owned spill cache (gz/text lazy runs)
    if close and not interrupted:
        ckpt.clear(pars.out)
    if report_throughput:
        meter.report()
    _log(pars, 1, "==> Freeing memory...")  # teardown banner (ngsDist.cpp:303)
    _log(pars, 1, "Done!")
    return matrices
