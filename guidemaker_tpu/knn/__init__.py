"""Exact k-nearest-neighbor engine for guide off-target search.

Replaces the reference's approximate NMSLib/HNSW index
(``core.py:418-523``) with exact, deterministic nearest-neighbor search:

* **Hamming**: guides are one-hot encoded so the match count between two
  guides is an inner product — the full distance computation is a tiled
  int8 (or bf16) matrix product, fused with the count or running top-k
  so the N x N distance matrix is never materialized (``hamming.py``;
  the GPU kernels in ``pallas_gpu.py``).
* **Levenshtein**: bit-parallel and banded DP vectorized over guide
  pairs; genome-scale retention rides the Hamming counting pass
  (``leven.py``).
* **Sharding**: the database shards across a device mesh; per-shard
  results merge with a ``psum`` / ``all_gather`` (``sharded.py``).

Exactness makes recall 1.0 by construction (the reference's tuned HNSW
achieves ~0.99, ``tests/GridOptimization.ipynb``), and index-based
tie-breaking makes results deterministic (the reference's ``set()`` ordering
was not, core.py:446).
"""
from .driver import KnnIndex, knn_search

__all__ = ["KnnIndex", "knn_search"]
