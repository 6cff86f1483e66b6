#!/usr/bin/env python
"""Smoke test of the guide-design pipeline on one GPU.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-cards # four cards: the mesh phase only

Phases (one card), each of which must pass; none is caught:

1. environment: the card, JAX, the compile cache, the dependencies;
2. kernels at real widths on the P. aeruginosa index (NGG 3', L=20,
   ~1.16 M unique guides): Hamming counting at --dist 2 and 3 over all
   guide pairs, gram counting (1152 features, --dist 4) over all pairs,
   top-k at k=3 and k=20 for 131,072 queries — each GPU kernel against
   the plain XLA version over the whole set, and both against the
   native/numpy oracle on a seeded sample of queries.  Tolerance is
   zero: operands are 0/1 and every sum is an exact integer;
3. golden: the C. ruddii table equals tests/test_data's golden CSV byte
   for byte;
4. main path: ``run_pipeline`` on P. aeruginosa (--dist 2, --knum 3,
   1000 controls, Doench and CFD) under hamming and under leven, with
   the stage table; the retained set equals phase 2's, and every control
   is at exact Hamming distance >= MINIMUM_HMDIST from the genome;
5. the ``gpu``-marked tests, in this process (a second JAX process on
   the card would find its memory taken).

With ``--four-cards`` it runs the sharded backend over a mesh of the
four cards (Hamming retention, k=3 lists, control triage, leven e=2
retention) and compares it bit for bit with the one-card path, run in
the same process on device 0.

The last line of standard output is one JSON object,
``{"ok": true, "device": {"platform", "kind", "count"}}``; a run
without a GPU fails before printing it.
"""
import argparse
import gzip
import io
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

# the card or nothing: JAX fails at start-up when it has no CUDA device
os.environ["JAX_PLATFORMS"] = "cuda"

REPO = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, REPO)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import guidemaker_tpu  # noqa: E402
from guidemaker_tpu import dna, native  # noqa: E402
from guidemaker_tpu.io import get_fastas, parse_fasta  # noqa: E402
from guidemaker_tpu.scan import PamTarget  # noqa: E402

PA_GBK = os.path.join(REPO, "guidemaker_tpu", "data",
                      "Pseudomonas_aeruginosa.gbk.gz")
CR_FASTA = os.path.join(REPO, "tests", "test_data",
                        "Carsonella_ruddii.fasta.gz")
CR_GBK = os.path.join(REPO, "tests", "test_data", "Carsonella_ruddii.gbk.gz")
GOLDEN = os.path.join(REPO, "tests", "test_data",
                      "golden_pretty_cruddii.csv.gz")
L = 20
SAMPLE = 2048          # oracle sample for counting and top-k
GRAM_SAMPLE = 256      # oracle sample for gram counting (host BLAS)
SEED = 0

_cache_events = {"hits": 0, "misses": 0}


def _on_event(event, **_):
    if event == "/jax/compilation_cache/cache_hits":
        _cache_events["hits"] += 1
    elif event == "/jax/compilation_cache/cache_misses":
        _cache_events["misses"] += 1


def say(msg):
    print(msg, flush=True)


def check(ok, what):
    if not ok:
        raise AssertionError(what)
    say(f"  OK {what}")


def phase(name):
    say(f"== {name}")
    return time.perf_counter()


def pa_codes(fasta):
    """Unique P. aeruginosa guides in the pipeline's order (NGG 3', L=20)."""
    targets = PamTarget("NGG", "3prime", "hamming").find_targets(
        parse_fasta(fasta), target_len=L)
    codes, _ = dna.encode_pandas(targets["target"].drop_duplicates())
    return codes


def environment():
    t = phase("1. environment")
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"chip_smoke: no GPU (JAX found {dev.platform})")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    say(f"card: {card}")
    say(f"jax {jax.__version__}; devices {jax.devices()}")
    say(f"compile cache: {guidemaker_tpu.COMPILE_CACHE_DIR}")
    for mod in ("pandas", "yaml", "pyarrow"):
        m = __import__(mod)
        say(f"import {mod}: {getattr(m, '__version__', 'ok')}")
    say(f"native library: {'built' if native.available() else 'absent'}")
    say(f"  ({time.perf_counter() - t:.1f} s)")
    return dev


def kernels(codes):
    """Phase 2; returns the Hamming retention mask (count(dist<2) <= 1)."""
    from guidemaker_tpu.knn import hamming as hm
    from guidemaker_tpu.knn import leven as lv
    from guidemaker_tpu.knn import pallas_gpu as pg
    t = phase("2. kernels at real widths")
    nd = len(codes)
    db = hm.prepare_db(codes)
    say(f"index: {nd} unique guides, features {db.shape} {db.dtype}")
    rng = np.random.default_rng(SEED)
    sample = np.sort(rng.choice(nd, SAMPLE, replace=False))
    # native oracle: exact (dist, idx) top-64 of the sample; the counts
    # below are exact where a row's 64th distance is past the threshold
    check(native.available(), "native oracle library builds")
    od, oi = native.hamming_topk(codes[sample], codes, 64)

    def oracle_counts(e):
        deep = od[:, -1] < e
        got = (od < e).sum(axis=1)
        for r in np.flatnonzero(deep):     # rows past 64 hits: numpy
            got[r] = int(((codes[sample[r]] != codes).sum(1) < e).sum())
        return got

    mask = None
    for e in (2, 3):
        comp = jax.jit(lambda q, d, e=e: pg.count_within(
            q, d, length=L, editdist=e)).lower(db, db).compile()
        say(f"count e={e} memory: {comp.memory_analysis()}")
        a = np.asarray(pg.count_within(db, db, length=L, editdist=e))[:nd]
        b = np.asarray(hm.count_feats(db, db, length=L, editdist=e,
                                      engine="xla"))[:nd]
        check(np.array_equal(a, b),
              f"count e={e}: kernel == XLA over all {nd}^2 pairs")
        check(np.array_equal(a[sample], oracle_counts(e)),
              f"count e={e}: kernel == native oracle on {SAMPLE} queries")
        if e == 2:
            mask = a <= 1
    # gram counting: 18 x 64 features, e=4 (t=3): dot > 18 - 10
    t_g, glen, p_edit = 3, L - lv.GRAM_Q + 1, 3 * lv.GRAM_Q + 1
    db_pad = jnp.asarray(hm.pad_code_rows(codes, hm.db_rows(nd)))
    gdb = lv._gram_feats_on_device(db_pad, t=t_g)
    gq = lv._gram_feats_on_device(db_pad, t=0)
    a = np.asarray(pg.count_within(gq, gdb, length=glen,
                                   editdist=p_edit))[:nd]
    b = np.asarray(hm.count_feats(gq, gdb, length=glen, editdist=p_edit,
                                  engine="xla"))[:nd]
    check(np.array_equal(a, b), f"gram count (K={gq.shape[1]}, e=4): "
          f"kernel == XLA over all {nd}^2 pairs")
    del gdb, gq
    gs = sample[:GRAM_SAMPLE]
    qf = lv._filter_feats(codes[gs], t_g, "q").astype(np.float32)
    want = np.zeros(len(gs), np.int64)
    for lo in range(0, nd, 131072):
        df = lv._filter_feats(codes[lo:lo + 131072], t_g, "db")
        want += ((qf @ df.astype(np.float32).T) > glen - p_edit).sum(1)
    check(np.array_equal(a[gs], want),
          f"gram count: kernel == numpy oracle on {GRAM_SAMPLE} queries")
    q131 = db[:131072]
    for k in (3, 20):
        ka = np.asarray(pg.topk_keys(q131, db, jnp.int32(nd), k=k, length=L))
        kb = np.asarray(hm.topk_feats(q131, db, nd, k=k, length=L,
                                      engine="xla"))
        check(np.array_equal(ka, kb),
              f"top-k k={k}: kernel == XLA for {q131.shape[0]} queries")
        sq = hm.onehot_on_device(jnp.asarray(codes[sample]))
        d, i = hm.keys_to_neighbors(np.asarray(pg.topk_keys(
            sq, db, jnp.int32(nd), k=k, length=L)), nd, k)
        check(np.array_equal(d, od[:, :k]) and np.array_equal(i, oi[:, :k]),
              f"top-k k={k}: kernel == native oracle on {SAMPLE} queries")
    say(f"  ({time.perf_counter() - t:.1f} s)")
    return mask


def golden():
    from guidemaker_tpu import definitions
    from guidemaker_tpu.annotate import Annotation
    from guidemaker_tpu.targets import TargetProcessor
    t = phase("3. golden C. ruddii table")
    targets = PamTarget("NGG", "5prime", "hamming").find_targets(
        parse_fasta(CR_FASTA), 20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=10)
    tl.check_restriction_enzymes(["NRAGCA"])
    tl.find_unique_near_pam()
    tl.create_index(configpath=definitions.CONFIG_PATH)
    say(f"backend: {tl.index.backend}")
    tl.get_neighbors(configpath=definitions.CONFIG_PATH)
    anno = Annotation(annotation_list=[CR_GBK], annotation_type="genbank",
                      target_bed_df=tl.export_bed())
    anno.get_annotation_features()
    anno._get_nearby_features()
    anno._filter_features(before_feat=100, after_feat=200)
    anno._get_qualifiers(configpath=definitions.CONFIG_PATH)
    anno._format_guide_table(tl)
    buf = io.StringIO()
    anno.pretty_df.to_csv(buf, index=False)
    with gzip.open(GOLDEN, "rt") as fh:
        check(buf.getvalue() == fh.read(), "CSV == golden, byte for byte")
    say(f"  ({time.perf_counter() - t:.1f} s)")


class _Stages(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        msg = record.getMessage()
        if msg.startswith("[stage]"):
            self.lines.append(msg)


def main_path(codes, retained):
    import yaml
    from guidemaker_tpu import definitions
    from guidemaker_tpu.pipeline import PipelineConfig, run_pipeline
    t = phase("4. main path: run_pipeline on P. aeruginosa")
    with open(definitions.CONFIG_PATH) as fh:
        min_hm = yaml.safe_load(fh)["CONTROL"]["MINIMUM_HMDIST"]
    timing = logging.getLogger("guidemaker_tpu.timing")
    timing.setLevel(logging.INFO)
    passed = {}
    for dtype in ("hamming", "leven"):
        stages = _Stages()
        timing.addHandler(stages)
        cfg = PipelineConfig(
            genbank=[PA_GBK], pamseq="NGG", pam_orientation="3prime",
            guidelength=L, dtype=dtype, dist=2, knum=3, controls=1000,
            doench_efficiency_score=True, cfd_score=True, seed=SEED,
            outdir=tempfile.mkdtemp(prefix=f"smoke-{dtype}-"))
        t0 = time.perf_counter()
        res = run_pipeline(cfg, write_outputs=True)
        wall = time.perf_counter() - t0
        timing.removeHandler(stages)
        say(f"{dtype}: wall {wall:.2f} s, backend "
            f"{res.processor.index.backend}, {len(res.targets)} guides")
        for line in stages.lines:
            say(f"  {line}")
        passed[dtype] = set(res.processor.passing_seqs())
        ctl = res.controls
        check(len(ctl) == 1000, f"{dtype}: 1000 controls")
        cc = np.stack([dna.encode(s) for s in ctl["Sequences"]])
        nearest, _ = native.hamming_topk(cc, codes, 1)
        check((nearest[:, 0] >= min_hm).all()
              and np.array_equal(nearest[:, 0],
                                 ctl["Hamming distance"].to_numpy()
                                 .astype(np.int32)),
              f"{dtype}: every control's exact nearest Hamming distance "
              f">= {min_hm} and as reported")
    want = set(dna.decode_rows(codes[retained]))
    check(passed["hamming"] == want,
          f"hamming retained set ({len(want)}) == phase 2's")
    check(passed["leven"] == want,
          "leven --dist 2 retained set == hamming's (leven<2 <=> hamming<2)")
    say(f"  ({time.perf_counter() - t:.1f} s)")


class _Outcomes:
    def __init__(self):
        self.passed = self.failed = self.skipped = 0

    def pytest_runtest_logreport(self, report):
        if report.when == "call" and report.passed:
            self.passed += 1
        elif report.failed:
            self.failed += 1
        elif report.skipped:
            self.skipped += 1


def card_tests():
    import pytest
    t = phase("5. gpu-marked tests (in this process)")
    out = _Outcomes()
    rc = pytest.main([os.path.join(REPO, "tests", "test_gpu_hw.py"), "-q",
                      "-m", "gpu", "-p", "no:cacheprovider"], plugins=[out])
    check(rc == 0 and out.failed == 0 and out.skipped == 0
          and out.passed > 0,
          f"gpu tests: {out.passed} passed, {out.failed} failed, "
          f"{out.skipped} skipped")
    say(f"  ({time.perf_counter() - t:.1f} s)")


def four_cards(codes):
    """Mesh phase: the sharded backend against the one-card path."""
    import yaml
    from guidemaker_tpu import definitions
    from guidemaker_tpu.knn import KnnIndex
    from guidemaker_tpu.targets import _control_chunk_rows, _device_sampler
    t = phase("mesh: sharded backend on 4 cards vs one card")
    check(len(jax.devices()) == 4, "4 devices")
    seqs = dna.decode_rows(codes)
    one = KnnIndex(seqs, "hamming", backend="pallas")
    mesh = KnnIndex(seqs, "hamming", backend="sharded")
    say(f"mesh (q, d) = {mesh._get_mesh().devices.shape}; engine "
        f"{mesh.engine}")
    t0 = time.perf_counter()
    r4 = mesh.pass_distance_filter(seqs, 2)
    t4 = time.perf_counter() - t0
    t0 = time.perf_counter()
    r1 = one.pass_distance_filter(seqs, 2)
    t1 = time.perf_counter() - t0
    say(f"retention wall: 4 cards {t4:.2f} s (first call), 1 card "
        f"{t1:.2f} s (first call)")
    check(np.array_equal(r4, r1), f"hamming retention ({int(r1.sum())} "
          f"retained) identical")
    keep = codes[r1]
    d4, i4 = mesh.query_codes(keep, 3)
    d1, i1 = one.query_codes(keep, 3)
    check(np.array_equal(d4, d1) and np.array_equal(i4, i1),
          f"k=3 lists of {len(keep)} retained guides identical")
    with open(definitions.CONFIG_PATH) as fh:
        ctl = yaml.safe_load(fh)["CONTROL"]
    rows = _control_chunk_rows(1000, ctl["CONTROL_SEARCH_MULTIPLE"])
    cum = jnp.cumsum(jnp.asarray([.25, .25, .25, .25], jnp.float32))
    chunks = [_device_sampler()(jax.random.PRNGKey(c), cum, m=rows,
                                length=L) for c in range(4)]
    m4 = mesh.pass_mask_chunks(chunks, ctl["MINIMUM_HMDIST"])
    m1 = one.pass_mask_chunks(chunks, ctl["MINIMUM_HMDIST"])
    check(np.array_equal(m4, m1), f"control triage of {4 * rows} "
          f"candidates identical ({int(m1.sum())} pass)")
    lev4 = KnnIndex(seqs, "leven", backend="sharded")
    lev1 = KnnIndex(seqs, "leven", backend="pallas")
    e4 = lev4.pass_distance_filter(seqs, 2)
    e1 = lev1.pass_distance_filter(seqs, 2)
    check(np.array_equal(e4, e1) and np.array_equal(e1, r1),
          "leven e=2 retention identical (and == hamming's)")
    say(f"  ({time.perf_counter() - t:.1f} s)")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the mesh phase, on four cards")
    args = ap.parse_args()
    jax.monitoring.register_event_listener(_on_event)
    t0 = time.perf_counter()
    dev = environment()
    fasta = get_fastas([PA_GBK], input_format="genbank",
                       tempdir=tempfile.mkdtemp(prefix="smoke-"))
    codes = pa_codes(fasta)
    if args.four_cards:
        four_cards(codes)
    else:
        retained = kernels(codes)
        golden()
        main_path(codes, retained)
        card_tests()
    say(f"compile cache: {_cache_events['hits']} hits, "
        f"{_cache_events['misses']} misses; total "
        f"{time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}), flush=True)


if __name__ == "__main__":
    main()
