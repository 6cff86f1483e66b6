#!/usr/bin/env python
"""Time each hand-written GPU kernel against the plain XLA version.

Builds the P. aeruginosa guide index (NGG 3', L=20, the bundled GenBank)
and, for every kernel in ``knn/pallas_gpu.py``, runs the kernel and its
XLA twin (``knn/hamming.py``) on the same inputs: once to compile, once
for the wall time (ended by ``block_until_ready``), and once under the
JAX profiler for the device time (the sum of the device events of that
call).  Also times the e=3 deletion-variant join on the device against
the host numpy sort.  Both engines' results are compared exactly.

With ``--e2e`` it instead runs the whole pipeline (``run_pipeline``,
--dist 2, --knum 3, 1000 controls, Doench + CFD) on P. aeruginosa with
the one-card backend on each engine, in the order kernel, XLA, XLA,
kernel, and prints each run's wall time and stage table.

    python tools/kernel_vs_xla.py [--out TRACE_DIR] [--e2e]

Needs a GPU; exits non-zero without one.  Prints one line per
measurement and a JSON summary as the last line.
"""
import argparse
import glob
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def device_seconds(trace_dir: str) -> float:
    """Sum of the device-side event durations in one profiler trace
    (GPU stream lines only, so nested op/module lines are not counted
    twice)."""
    from jax.profiler import ProfileData
    path = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                     recursive=True)[0]
    total = 0
    for plane in ProfileData.from_file(path).planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            if line.name.startswith("Stream"):
                total += sum(e.duration_ns for e in line.events)
    return total / 1e9


def measure(name, fn, out_dir):
    import jax
    jax.block_until_ready(fn())                 # compile + warm
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    wall = time.perf_counter() - t0
    tdir = tempfile.mkdtemp(prefix=name + "-", dir=out_dir)
    with jax.profiler.trace(tdir):
        jax.block_until_ready(fn())
    dev = device_seconds(tdir)
    print(f"{name}: wall {wall:.6f} s, device {dev:.6f} s", flush=True)
    return out, {"wall_s": wall, "device_s": dev}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="directory for the profiler traces (default: a "
                         "temporary one)")
    ap.add_argument("--e2e", action="store_true",
                    help="time run_pipeline on each engine instead")
    args = ap.parse_args()
    import jax
    import jax.numpy as jnp
    if jax.devices()[0].platform != "gpu":
        sys.exit("kernel_vs_xla: no GPU found")
    args.out = args.out or tempfile.mkdtemp(prefix="kernel-traces-")
    os.makedirs(args.out, exist_ok=True)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print("card:", card.strip(), flush=True)
    if args.e2e:
        return e2e()

    from guidemaker_tpu.io import parse_fasta, get_fastas
    from guidemaker_tpu.scan import PamTarget
    from guidemaker_tpu import dna
    from guidemaker_tpu.knn import hamming as hm, pallas_gpu as pg
    from guidemaker_tpu.knn import leven as lv
    gbk = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "guidemaker_tpu", "data",
        "Pseudomonas_aeruginosa.gbk.gz")
    fasta = get_fastas([gbk], input_format="genbank",
                       tempdir=tempfile.mkdtemp())
    targets = PamTarget("NGG", "3prime", "hamming").find_targets(
        parse_fasta(fasta), target_len=20)
    codes, _ = dna.encode_pandas(targets["target"].drop_duplicates())
    nd, L = codes.shape
    db = hm.prepare_db(codes)
    q131 = db[:131072]
    print(f"index: {nd} unique guides, features {db.shape}", flush=True)
    res = {}
    pairs = {
        "count_e2_all": (
            lambda: pg.count_within(db, db, length=L, editdist=2),
            lambda: hm.count_feats(db, db, length=L, editdist=2,
                                   engine="xla")),
    }
    for k in (3, 20):
        pairs[f"topk_k{k}_131k"] = (
            lambda k=k: pg.topk_keys(q131, db, jnp.int32(nd), k=k, length=L),
            lambda k=k: hm.topk_feats(q131, db, nd, k=k, length=L,
                                      engine="xla"))
    gdb = lv._gram_feats_on_device(jnp.asarray(
        hm.pad_code_rows(codes, hm.db_rows(nd))), t=3)
    gq = lv._gram_feats_on_device(jnp.asarray(codes[:131072]), t=0)
    pairs["gram_count_e4_131k"] = (
        lambda: pg.count_within(gq, gdb, length=18, editdist=10),
        lambda: hm.count_feats(gq, gdb, length=18, editdist=10,
                               engine="xla"))
    for name, (kern, xla) in pairs.items():
        a, ra = measure(name + "_kernel", kern, args.out)
        b, rb = measure(name + "_xla", xla, args.out)
        same = bool((np.asarray(a) == np.asarray(b)).all())
        print(f"{name}: kernel == xla: {same}", flush=True)
        res[name] = {"kernel": ra, "xla": rb, "equal": same}
    dev_join, rd = measure(
        "delset_join_device",
        lambda: lv._delset_partner_device(jnp.asarray(codes), length=L),
        args.out)
    t0 = time.perf_counter()
    host_join = lv._delset_partner_mask(codes)
    th = time.perf_counter() - t0
    same = bool((np.asarray(dev_join) == host_join).all())
    print(f"delset_join_host: wall {th:.6f} s; device == host: {same}")
    res["delset_join"] = {"device": rd, "host_wall_s": th, "equal": same}
    print(json.dumps({"card": card.strip(), "nd": nd, "results": res}))


def e2e():
    """run_pipeline on P. aeruginosa per engine: kernel, XLA, XLA, kernel."""
    import logging
    from guidemaker_tpu.knn import driver
    from guidemaker_tpu.pipeline import PipelineConfig, run_pipeline
    gbk = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "guidemaker_tpu", "data",
        "Pseudomonas_aeruginosa.gbk.gz")
    timing = logging.getLogger("guidemaker_tpu.timing")
    timing.setLevel(logging.INFO)
    runs = []
    for backend in ("pallas", "xla", "xla", "pallas"):
        stages = {}

        class Grab(logging.Handler):
            def emit(self, record):
                msg = record.getMessage()
                if msg.startswith("[stage]"):
                    parts = msg.split()
                    stages[" ".join(parts[1:-5])] = float(parts[-5])

        grab = Grab()
        timing.addHandler(grab)
        driver._default_backend = lambda b=backend: b
        cfg = PipelineConfig(
            genbank=[gbk], pamseq="NGG", pam_orientation="3prime",
            guidelength=20, dist=2, knum=3, controls=1000, seed=0,
            doench_efficiency_score=True, cfd_score=True,
            outdir=tempfile.mkdtemp(prefix="e2e-"))
        t0 = time.perf_counter()
        res = run_pipeline(cfg)
        wall = time.perf_counter() - t0
        timing.removeHandler(grab)
        print(f"e2e {backend}: wall {wall:.3f} s, {len(res.targets)} guides, "
              f"stages {json.dumps(stages)}", flush=True)
        runs.append({"backend": backend, "wall_s": wall, "stages": stages})
    print(json.dumps({"e2e": runs}))


if __name__ == "__main__":
    main()
