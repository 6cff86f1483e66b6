"""Exactness/agreement report: every k-NN backend vs the brute-force oracle.

The reference's GridOptimization.ipynb measured HNSW recall (0.99 at its
tuned parameters).  This script is the rebuild's analog: it demonstrates
recall 1.0 and byte-agreement across all engines on the same workload.

Usage: python tools/verify_exactness.py [fasta_or_gbk] [k]
"""
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np


def main():
    import jax
    path = sys.argv[1] if len(sys.argv) > 1 else os.path.join(
        os.path.dirname(__file__), "..", "tests", "test_data",
        "Carsonella_ruddii.fasta.gz")
    k = int(sys.argv[2]) if len(sys.argv) > 2 else 3

    from guidemaker_tpu import PamTarget, dna
    from guidemaker_tpu.io import parse_fasta, parse_genbank
    from guidemaker_tpu.knn.driver import KnnIndex, _default_backend

    recs = (parse_genbank(path) if path.endswith((".gbk", ".gbk.gz", ".gb"))
            else parse_fasta(path))
    targets = PamTarget("NGG", "5prime", "hamming").find_targets(
        [r.upper() for r in recs], 20)
    uniq = list(dict.fromkeys(targets["target"]))
    print(f"{len(uniq)} unique guides; k={k}; "
          f"platform={jax.devices()[0].platform}")

    # brute-force oracle (numpy, chunked)
    codes = dna.encode_batch(uniq, 20)
    oracle_d = np.empty((len(uniq), k), np.int32)
    oracle_i = np.empty((len(uniq), k), np.int32)
    for lo in range(0, len(uniq), 512):
        d = (codes[lo:lo + 512, None, :] != codes[None, :, :]).sum(2)
        key = d.astype(np.int64) * (1 << 24) + np.arange(len(uniq))[None, :]
        part = np.sort(key, axis=1)[:, :k]
        oracle_d[lo:lo + 512] = (part >> 24).astype(np.int32)
        oracle_i[lo:lo + 512] = (part & ((1 << 24) - 1)).astype(np.int32)

    backends = list(dict.fromkeys(["xla", "native", _default_backend()]))
    for backend in backends:
        t0 = time.time()
        d, i = KnnIndex(uniq, backend=backend).query(uniq, k)
        dt = time.time() - t0
        exact = (d == oracle_d).all() and (i == oracle_i).all()
        recall = (d == oracle_d).mean()
        print(f"  {backend:8s}: recall {recall:.6f} exact-match={exact} "
              f"({dt:.3f}s incl. build+transfer)")


if __name__ == "__main__":
    main()
