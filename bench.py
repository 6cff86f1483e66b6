#!/usr/bin/env python
"""Benchmark: exact genome-wide guide design vs the reference's HNSW.

Headline (the JSON line's ``metric``): the genome-scale retention pass —
every guide of the 6.3 Mb Pseudomonas aeruginosa genome against every
other (1.34e12 guide pairs) through the GPU counting kernel
(knn/pallas_gpu.py), exactly the kernel the pipeline's `exact k-NN`
stage runs on one card.

Baseline: the reference's only published k-NN numbers are HNSW on the
C. ruddii target set (BASELINE.md): tuned M=16/efC=16/ef=13 takes
0.090 s at recall ~0.99 for 3,814 queries x 3,814 targets x k=3 =
1.456e7 query-pairs -> 1.62e8 pairs/s on 4 CPU threads.  vs_baseline is
the per-pair rate ratio on our genome-scale workload (recall 1.0 by
construction vs their 0.99).

The cumulative JSON record is printed to stdout after every section (the
last complete line wins), and a SIGTERM emits it before exiting; every
section has a remaining-time gate and records a skip it cannot fit.
The record names the card and its power limit.  Without a GPU the bench
fails: it never reports a CPU time as a device number.

Sections, in order: retention headline, 131k top-k, full-pipeline e2e
(warm, with stage table), leven e=2 retention, leven e=3 retention
(hamming counting + deletion-set join), leven survivor list phase
(bit-parallel Myers), --dtype leven e2e, C. ruddii k=3 (direct
HNSW-baseline comparison).
"""
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402  (module import only; backend init is lazy)

BASELINE_HNSW_TUNED_S = 0.090           # GridOptimization.ipynb cells 28-33
BASELINE_HNSW_PAIRS = 3814 * 3814       # same-workload pair count
BASELINE_PAIRS_PER_S = BASELINE_HNSW_PAIRS / BASELINE_HNSW_TUNED_S
BASELINE_E2E_S = 90.0                   # reference README.md:15: ~1-2 min

#: soft ceiling: the record is re-emitted after every section and the
#: SIGTERM handler emits on an external kill, so a shorter window loses
#: nothing already measured.
BUDGET_S = float(os.environ.get("GUIDEMAKER_BENCH_BUDGET_S", "900"))
T0 = time.time()

record: dict = {}
_skipped: dict = {}


def log(msg):
    print(msg, file=sys.stderr, flush=True)


def remaining():
    return BUDGET_S - (time.time() - T0)


def emit():
    """Print the cumulative record as one JSON line (last line wins)."""
    out = dict(record)
    if "metric" not in out:
        # headline not yet measured: still emit something parseable
        out.update(metric="bench_incomplete", value=round(time.time() - T0, 1),
                   unit="s", vs_baseline=0.0)
    if _skipped:
        out["skipped_sections"] = dict(_skipped)
    out["bench_elapsed_s"] = round(time.time() - T0, 1)
    print(json.dumps(out), flush=True)


def _die(signum, frame):
    log(f"  [bench] signal {signum} at t={time.time()-T0:.0f}s; "
        "emitting record and exiting")
    emit()
    sys.stdout.flush()
    os._exit(0)


def section(name, budget_s):
    """Decorator-ish gate: returns False (and records the skip) when the
    remaining time cannot cover ``budget_s``."""
    rem = remaining()
    if rem < budget_s:
        _skipped[name] = f"needs ~{budget_s:.0f}s, {rem:.0f}s left"
        log(f"  [bench] SKIP {name}: needs ~{budget_s:.0f}s, "
            f"{rem:.0f}s left")
        return False
    log(f"  [bench] section {name} (t={time.time()-T0:.0f}s, "
        f"budget {budget_s:.0f}s)")
    return True


# ---------------------------------------------------------------------------
# workload helpers
# ---------------------------------------------------------------------------

def load_targets(path, pam="NGG", orientation="5prime", length=20):
    from guidemaker_tpu import PamTarget, dna
    from guidemaker_tpu.io import parse_genbank, parse_fasta
    t0 = time.time()
    if path.endswith(("gbk.gz", "gbk", "gb")):
        recs = list(parse_genbank(path))
    else:
        recs = list(parse_fasta(path))
    recs = [r.upper() for r in recs]
    genome_bp = sum(len(r.seq) for r in recs)
    targets = PamTarget(pam, orientation, "hamming").find_targets(recs, length)
    uniq = list(dict.fromkeys(targets["target"].tolist()))
    codes = np.stack([dna.encode(s) for s in uniq]).astype(np.uint8)
    log(f"  {os.path.basename(path)}: {genome_bp:,} bp, "
        f"{len(targets)} targets, {len(uniq)} unique ({time.time()-t0:.2f}s host)")
    return codes, len(uniq), genome_bp


REPS_LO, REPS_HI = 8, 64


def bench_cruddii(codes, k, length, *, repeats=5):
    """C. ruddii k=3 steady-state: dependency-chained reps of the top-k
    kernel inside one jit, slope-timed to cancel dispatch and transfer
    (the baseline's 0.090 s measured in-memory local compute)."""
    import functools
    import jax.numpy as jnp
    from guidemaker_tpu.knn import pallas_gpu as pg
    from guidemaker_tpu.knn.hamming import (INF_KEY, onehot_on_device,
                                            prepare_db, unpack_keys)

    nd = codes.shape[0]
    db_dev = prepare_db(codes)
    q_dev = onehot_on_device(jnp.asarray(codes))

    t0 = time.time()
    keys = pg.topk_keys(q_dev, db_dev, jnp.int32(nd), k=k,
                        length=length).block_until_ready()
    compile_s = time.time() - t0
    dist, idx = unpack_keys(np.asarray(keys))
    assert (dist[:, 0] == 0).all(), "self-distance must be 0"
    assert (idx[:, 0] == np.arange(nd)).all(), "self-index mismatch"

    @functools.partial(jax.jit, static_argnames=("reps",))
    def chained(q, db, *, reps):
        def body(_, carry):
            # data dependency between reps so XLA cannot elide them:
            # carry[0,0] is a real top-k key, never INF_KEY+1, so dep is
            # always exactly 0 and q + 0 == q
            dep = jnp.where(carry[0, 0] == INF_KEY + 1, 1, 0)
            return pg.topk_keys(q + dep.astype(q.dtype), db, jnp.int32(nd),
                                k=k, length=length)
        init = jnp.full((q.shape[0], k), INF_KEY, dtype=jnp.int32)
        return jax.lax.fori_loop(0, reps, body, init)

    def timed(reps):
        np.asarray(chained(q_dev, db_dev, reps=reps)[0, :k])  # warm
        ts = []
        for _ in range(repeats):
            t0 = time.time()
            np.asarray(chained(q_dev, db_dev, reps=reps)[0, :k])
            ts.append(time.time() - t0)
        return min(ts)

    t_lo, t_hi = timed(REPS_LO), timed(REPS_HI)
    per_run = max((t_hi - t_lo) / (REPS_HI - REPS_LO), 1e-9)
    return float(per_run), compile_s


def run_e2e(stages: dict, *, controls=1000, seed=42, dtype="hamming"):
    """Full-pipeline wall time on P. aeruginosa (the reference's headline
    workload: README.md:15 '1-2 minutes on a laptop' for a typical
    bacterial genome), with the per-stage breakdown captured from the
    pipeline's stage timers.  ``dtype`` selects the guide metric — the
    reference treats hamming and leven as co-equal modes (core.py:459-467),
    so both get a measured end-to-end here."""
    import logging

    from guidemaker_tpu.pipeline import PipelineConfig, run_pipeline

    class StageGrab(logging.Handler):
        def emit(self, record):
            msg = record.getMessage()
            if "[stage]" in msg:
                name, secs = _parse_stage_line(msg)
                stages[name] = secs

    grab = StageGrab()
    timing_logger = logging.getLogger("guidemaker_tpu.timing")
    timing_logger.addHandler(grab)
    timing_logger.setLevel(logging.INFO)
    out = tempfile.mkdtemp(prefix="gm_bench_e2e_")
    cfg = PipelineConfig(
        genbank=[os.path.join(REPO, "guidemaker_tpu", "data",
                              "Pseudomonas_aeruginosa.gbk.gz")],
        pamseq="NGG", pam_orientation="3prime", guidelength=20, lsr=10,
        dtype=dtype, dist=2, before=100, into=200, knum=3,
        controls=controls, threads=2, doench_efficiency_score=True,
        cfd_score=True, outdir=out, seed=seed)
    t0 = time.time()
    res = run_pipeline(cfg)
    e2e = time.time() - t0
    timing_logger.removeHandler(grab)
    log(f"  P. aeruginosa end-to-end: {e2e:.2f} s, "
        f"{len(res.targets)} guides, {cfg.controls} controls")
    for name, secs in stages.items():
        log(f"    {name:<16} {secs:8.3f} s")
    return e2e, len(res.targets)


# ---------------------------------------------------------------------------
# main
# ---------------------------------------------------------------------------

def main():
    signal.signal(signal.SIGTERM, _die)
    try:
        _main_body()
    finally:
        # ANY exit path — including an unhandled exception in a section
        # that predates the first successful emit — leaves a parseable
        # record on stdout
        emit()


def _main_body():
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench: no GPU (JAX found {dev.platform}); "
                         "device numbers come only from a GPU run")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    log(f"device: {dev.platform} {dev.device_kind} x{len(jax.devices())} "
        f"({card}) budget {BUDGET_S:.0f}s")
    record["device"] = {"platform": dev.platform, "kind": dev.device_kind,
                        "count": len(jax.devices())}
    record["card"] = card
    import guidemaker_tpu
    record["version"] = guidemaker_tpu.__version__

    # --- headline: P. aeruginosa genome-wide retention (6.3 Mb) ---
    pa_codes = None
    if section("retention", 60):
        try:
            from guidemaker_tpu.knn import pallas_gpu as pg
            from guidemaker_tpu.knn.hamming import (keys_to_neighbors,
                                                    onehot_on_device,
                                                    prepare_db)
            pa = os.path.join(REPO, "guidemaker_tpu", "data",
                              "Pseudomonas_aeruginosa.gbk.gz")
            pa_codes, n2, bp2 = load_targets(pa)
            dbb = prepare_db(pa_codes)

            def count():
                return np.asarray(pg.count_within(dbb, dbb, length=20,
                                                  editdist=2))[:n2]
            t0 = time.time()
            counts = count()
            compile_s = time.time() - t0
            retained = int((counts <= 1).sum())
            times = []
            for _ in range(3):
                t0 = time.time()
                count()
                times.append(time.time() - t0)
            tc = min(times)
            pairs = n2 * n2
            rate = pairs / tc
            record.update(
                metric="pa_genomewide_retention_pairs_per_s",
                value=round(rate, 0), unit="pairs/s",
                vs_baseline=round(rate / BASELINE_PAIRS_PER_S, 2),
                retention_seconds=round(tc, 3),
                retention_compile_s=round(compile_s, 1),
                retention_guides=retained)
            log(f"  P. aeruginosa retention (all-vs-all, {pairs:.3g} pairs): "
                f"{tc:.2f} s steady ({compile_s:.1f}s first call), "
                f"{rate/1e12:.2f} T pairs/s, {retained} guides retained")
        except Exception as e:  # headline failure must still leave a record
            log(f"  retention failed: {e!r}")
            record["retention_error"] = repr(e)[:200]
            pa_codes = None
        emit()

    # post-annotation top-k pass (the other genome-scale kernel)
    if pa_codes is None:
        _skipped.setdefault("topk131k", "retention prerequisites missing")
    elif section("topk131k", 30):
        try:
            import jax.numpy as jnp
            nsub = 131072

            def topk():
                q = onehot_on_device(jnp.asarray(pa_codes[:nsub]))
                return keys_to_neighbors(np.asarray(pg.topk_keys(
                    q, dbb, jnp.int32(n2), k=3, length=20)), n2, 3)
            topk()                                   # compile + run
            t0 = time.time()
            topk()
            tk = time.time() - t0
            record["topk_131k_seconds"] = round(tk, 2)
            record["topk_pairs_per_s"] = round(nsub * n2 / tk)
            log(f"  P. aeruginosa top-3 for {nsub} retained guides: "
                f"{tk:.2f} s e2e, {nsub*n2/tk/1e12:.2f} T pairs/s")
        except Exception as e:
            log(f"  topk131k failed: {e!r}")
        emit()

    # --- full pipeline end-to-end (the reference's 1-2 min workload),
    # min of 2 runs; both wall times are recorded ---
    if section("e2e", 120):
        runs = []
        try:
            for rep in range(2):
                stages: dict = {}
                e2e_seconds, e2e_guides = run_e2e(stages)
                runs.append((e2e_seconds, stages, e2e_guides))
                record["e2e_seconds_runs"] = [round(r[0], 2) for r in runs]
                best = min(runs, key=lambda r: r[0])
                record["e2e_seconds"] = round(best[0], 2)
                record["e2e_guides"] = best[2]
                record["e2e_stages"] = {k: round(v, 2)
                                        for k, v in best[1].items()}
                record["e2e_vs_baseline"] = round(BASELINE_E2E_S / best[0], 2)
                emit()
                if rep == 0 and remaining() < 200:
                    _skipped["e2e_rep2"] = "budget"
                    break
        except Exception as e:  # e2e detail must not sink the headline
            log(f"  e2e pipeline run failed: {e!r}")
            if not runs:
                record["e2e_error"] = repr(e)[:200]
        emit()

    # --- Levenshtein retention: e=2 rides the Hamming counting kernel;
    # e=3 adds the deletion-variant join (exact decomposition) ---
    for e, key in ((2, "leven_retention_pairs_per_s"),
                   (3, "leven_e3_retention_pairs_per_s")):
        name = f"leven_e{e}"
        if pa_codes is None:
            _skipped.setdefault(name, "retention prerequisites missing")
            continue
        if not section(name, 60):
            continue
        try:
            from guidemaker_tpu.knn.leven import leven_pass_filter
            t0 = time.time()
            passed = leven_pass_filter(pa_codes, pa_codes, e,
                                       engine="pallas")
            compile_s = time.time() - t0
            times = []
            for _ in range(2):
                t0 = time.time()
                leven_pass_filter(pa_codes, pa_codes, e, engine="pallas")
                times.append(time.time() - t0)
            tl_ = min(times)
            pairs = pa_codes.shape[0] ** 2
            record[key] = round(pairs / tl_)
            if e == 3:
                record["leven_e3_seconds"] = round(tl_, 2)
            log(f"  P. aeruginosa LEVEN retention e={e}: {tl_:.2f} s steady "
                f"({compile_s:.1f}s first call), {pairs/tl_/1e12:.2f} T "
                f"pairs/s, {int(passed.sum())} retained")
        except Exception as ex:
            log(f"  leven e{e} failed: {ex!r}")
        emit()

    # --- Levenshtein survivor list phase (the post-annotation neighbor
    # lists for --dtype leven): bit-parallel Myers in plain XLA ---
    if pa_codes is None:
        _skipped.setdefault("leven_lists", "retention prerequisites missing")
    elif section("leven_lists", 75):
        try:
            from guidemaker_tpu.knn import leven as lv
            nsub = 131072
            nd = pa_codes.shape[0]
            fn = lv.leven_topk
            fn(pa_codes[:1024], pa_codes, 3)          # compile on small slice
            t0 = time.time()
            fn(pa_codes[:nsub], pa_codes, 3)
            tk_l = time.time() - t0
            record["leven_list_131k_seconds"] = round(tk_l, 2)
            record["leven_list_pairs_per_s"] = round(nsub * nd / tk_l)
            record["leven_list_kernel"] = "leven_topk[myers]"
            log(f"  P. aeruginosa LEVEN top-3 lists for {nsub} survivors: "
                f"{tk_l:.2f} s ({fn.__name__}), "
                f"{nsub*nd/tk_l/1e12:.3f} T pairs/s")
        except Exception as e:
            log(f"  leven list phase failed: {e!r}")
        emit()

    # --- full --dtype leven pipeline end-to-end (the reference treats
    # leven as a co-equal mode, core.py:459-467) ---
    if section("leven_e2e", 120):
        lstages: dict = {}
        try:
            lev_e2e, lev_guides = run_e2e(lstages, dtype="leven")
            record["leven_e2e_seconds"] = round(lev_e2e, 2)
            record["leven_e2e_guides"] = lev_guides
            record["leven_e2e_stages"] = {k: round(v, 2)
                                          for k, v in lstages.items()}
        except Exception as e:
            log(f"  leven e2e failed: {e!r}")
            record["leven_e2e_error"] = repr(e)[:200]
        emit()

    # --- C. ruddii k=3 steady (direct HNSW-baseline comparison) ---
    if section("cruddii", 35):
        try:
            cr = os.path.join(REPO, "tests", "test_data",
                              "Carsonella_ruddii.gbk.gz")
            cr_codes, n, _ = load_targets(cr)
            t_med, t_compile = bench_cruddii(cr_codes, 3, 20)
            record["cruddii_k3_seconds"] = round(t_med, 6)
            record["cruddii_vs_hnsw_tuned"] = round(
                BASELINE_HNSW_TUNED_S / t_med, 1)
            log(f"  C. ruddii exact k=3: {t_med*1e3:.3f} ms steady "
                f"({t_compile:.1f}s first-call compile), "
                f"{n*n/t_med/1e9:.2f} G pairs/s "
                f"(HNSW tuned baseline: 90 ms at recall 0.99)")
        except Exception as e:
            log(f"  C. ruddii run skipped: {e!r}")
        emit()


def _parse_stage_line(msg):
    """Parse util.stage_timer's '[stage] <name> <secs> s (cpu ...)' log
    line into (name, seconds)."""
    parts = msg.split("[stage]")[1].split()
    return " ".join(parts[:-5]), float(parts[-5])


if __name__ == "__main__":
    main()
