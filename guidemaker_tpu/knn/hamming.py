"""Exact Hamming k-NN as one-hot matrix products.

The Hamming distance between two equal-length ACGT guides is
``L - matches``, and ``matches`` is the inner product of their one-hot
encodings.  So the all-pairs distance computation is a product of
``(nq, 4L) @ (4L, nd)`` one-hot matrices; 0/1 operands and sums <= the
feature width are exact in int8/int32 and in bf16/f32 alike.

Features live on the device as int8 one-hots (built there from the 2-bit
codes).  Two engines evaluate them, selected by the driver from the
platform:

* ``"pallas"`` — the fused GPU kernels of :mod:`.pallas_gpu`;
* ``"xla"`` — the plain version below: per database tile a bf16 product
  (f32 accumulation) followed by a compare-and-sum or a ``lax.top_k``
  merge, under ``lax.scan``.  It runs everywhere and is the reference the
  kernels are checked against.

Neighbours are returned as packed int32 sort keys ``(dist << 24) | idx``,
which order ascending by (distance, database index) — the reference's
"hit 0 is self" semantics (core.py:502-523) without its nondeterministic
``set()`` ordering.
"""
from __future__ import annotations

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np

#: bits reserved for the database index inside the packed int32 sort key.
IDX_BITS = 24
IDX_MASK = (1 << IDX_BITS) - 1
#: sentinel key larger than any real (dist, idx) pair.
INF_KEY = np.int32(1 << 30)

MAX_DB = 1 << IDX_BITS  # 16.7M guides per shard; shard beyond this.

#: database rows per XLA scan step (databases are padded to a multiple)
DB_TILE = 8192


def pack_keys(dist: jnp.ndarray, idx: jnp.ndarray) -> jnp.ndarray:
    """(distance, db index) -> single int32 ascending sort key."""
    return (dist.astype(jnp.int32) << IDX_BITS) | idx.astype(jnp.int32)


def unpack_keys(keys: np.ndarray):
    """Packed keys -> (dist, idx); sentinel keys -> (-1, -1)."""
    keys = np.asarray(keys)
    invalid = keys >= INF_KEY
    dist = (keys >> IDX_BITS).astype(np.int32)
    idx = (keys & IDX_MASK).astype(np.int32)
    dist[invalid] = -1
    idx[invalid] = -1
    return dist, idx


def keys_to_neighbors(keys, nd: int, k: int):
    """(nq, k_eff) device or host keys -> host (dists, idx), each (nq, k):
    entries past the database (``idx >= nd``) and the columns beyond
    ``k_eff`` are (-1, -1)."""
    dist, idx = unpack_keys(np.asarray(keys))
    bad = idx >= nd
    dist[bad] = -1
    idx[bad] = -1
    if dist.shape[1] < k:
        pad = np.full((dist.shape[0], k - dist.shape[1]), -1, dtype=np.int32)
        dist = np.concatenate([dist, pad], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return dist, idx


def feat_width(f: int) -> int:
    """Feature width the kernels take: a power of two (>= 32) up to 128,
    a multiple of 128 above (the contraction runs in 128-wide chunks)."""
    if f <= 128:
        return max(32, 1 << (f - 1).bit_length())
    return -(-f // 128) * 128


@jax.jit
def onehot_on_device(codes) -> jnp.ndarray:
    """(n, L) uint8 codes -> (n, feat_width(4L)) int8 one-hot, on device.

    Transfers 2-bit codes instead of the 4x wider one-hot.  Out-of-range
    codes (INVALID=4, also used for row padding) one-hot to all-zero, so
    padding never matches anything.
    """
    n, length = codes.shape
    oh = jax.nn.one_hot(codes, 4, dtype=jnp.int8).reshape(n, 4 * length)
    pad = feat_width(4 * length) - 4 * length
    if pad:
        oh = jnp.pad(oh, ((0, 0), (0, pad)))
    return oh


def bucket_rows(n: int, tile: int) -> int:
    """Row count padded to ``tile * next_pow2(n_tiles)``: compiled
    programs then come from a logarithmic set of shapes instead of one
    per batch size."""
    tiles = max(1, -(-n // tile))
    return tile * (1 << (tiles - 1).bit_length())


def pad_code_rows(codes: np.ndarray, multiple: int) -> np.ndarray:
    """Pad (n, L) codes with INVALID rows to a multiple of ``multiple``."""
    pad = (-codes.shape[0]) % multiple
    if pad:
        codes = np.concatenate(
            [codes, np.full((pad, codes.shape[1]), 4, dtype=np.uint8)])
    return codes


def _pad_rows(arr: np.ndarray, multiple: int) -> np.ndarray:
    n = arr.shape[0]
    pad = (-n) % multiple
    if pad:
        arr = np.concatenate([arr, np.zeros((pad,) + arr.shape[1:], arr.dtype)])
    return arr


def fit_tile(requested: int, n: int, floor: int = 256) -> int:
    """Shrink a tile to the next power of two covering n (min ``floor``)."""
    return min(requested, max(floor, 1 << (int(n - 1).bit_length())))


def db_rows(nd: int) -> int:
    """Padded row count of a resident database of ``nd`` guides."""
    t = fit_tile(DB_TILE, nd)
    return -(-nd // t) * t


def prepare_db(codes: np.ndarray):
    """Pad (INVALID rows) + transfer the database codes once and one-hot
    them on device: the resident int8 feature matrix both engines read."""
    return onehot_on_device(jnp.asarray(pad_code_rows(codes,
                                                      db_rows(len(codes)))))


def _merge_topk(best: jnp.ndarray, cand_keys: jnp.ndarray, k: int) -> jnp.ndarray:
    """Merge candidate keys into the running per-row top-k (smallest keys)."""
    allk = jnp.concatenate([best, cand_keys], axis=1)
    neg_top, _ = jax.lax.top_k(-allk, k)
    return -neg_top


def _tile_matches(q, db, t, db_tile):
    tile = jax.lax.dynamic_slice_in_dim(db, t * db_tile, db_tile)
    return jnp.dot(q.astype(jnp.bfloat16), tile.astype(jnp.bfloat16).T,
                   preferred_element_type=jnp.float32)


def _topk_tiles_body(q_oh, db_oh, db_n, idx_offset, *, k, length, db_tile):
    """Running top-k of packed keys for one query block over all db tiles.

    Args:
      q_oh: (tq, F) one-hot queries (int8 or bf16).
      db_oh: (nd_pad, F) one-hot database, nd_pad % db_tile == 0.
      db_n: scalar int32, number of valid database rows.
      idx_offset: scalar int32 added to local indices (global shard offset).
    Returns:
      (tq, k) int32 packed keys, ascending.
    """
    n_tiles = db_oh.shape[0] // db_tile
    tq = q_oh.shape[0]
    init = jnp.full((tq, k), INF_KEY, dtype=jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, db_tile), 1)

    def body(best, t):
        matches = _tile_matches(q_oh, db_oh, t, db_tile)
        dist = (jnp.float32(length) - matches).astype(jnp.int32)
        gidx = t * db_tile + lane
        keys = jnp.where(gidx < db_n,
                         pack_keys(dist, gidx + idx_offset),
                         INF_KEY)
        return _merge_topk(best, keys, k), None

    best, _ = jax.lax.scan(body, init, jnp.arange(n_tiles, dtype=jnp.int32))
    return best


@functools.partial(jax.jit,
                   static_argnames=("k", "length", "db_tile", "q_tile"))
def _topk_all(q_pad, db_oh, db_n, idx_offset, *, k, length, db_tile, q_tile):
    """All query tiles in ONE dispatch (lax.map over query blocks)."""
    nq_pad, feat = q_pad.shape
    tiles = q_pad.reshape(nq_pad // q_tile, q_tile, feat)
    out = jax.lax.map(
        lambda q: _topk_tiles_body(q, db_oh, db_n, idx_offset,
                                   k=k, length=length, db_tile=db_tile),
        tiles)
    return out.reshape(nq_pad, k)


@functools.partial(jax.jit,
                   static_argnames=("editdist", "length", "db_tile",
                                    "q_tile"))
def _count_all(q_pad, db_oh, *, editdist, length, db_tile, q_tile):
    """count(dist < editdist) per query, all query tiles in one dispatch.

    Padding rows (all-zero one-hot) have dist == length >= editdist, so
    padded database rows are never counted; padded query rows get counts
    that callers slice off.
    """
    nq_pad, feat = q_pad.shape
    n_tiles = db_oh.shape[0] // db_tile
    thresh = jnp.float32(length - editdist)
    tiles = q_pad.reshape(nq_pad // q_tile, q_tile, feat)

    def one(q):
        def body(cnt, t):
            hit = _tile_matches(q, db_oh, t, db_tile) > thresh
            return cnt + jnp.sum(hit.astype(jnp.int32), axis=1), None

        cnt, _ = jax.lax.scan(body, jnp.zeros((q_tile,), jnp.int32),
                              jnp.arange(n_tiles, dtype=jnp.int32))
        return cnt

    return jax.lax.map(one, tiles).reshape(nq_pad)


def _xla_tiles(nq: int, nd_rows: int):
    return fit_tile(2048, nq), math.gcd(nd_rows, DB_TILE)


def count_feats(q_feat, db_feat, *, length: int, editdist: int,
                engine: str):
    """(nq,) int32 device counts of database rows with Hamming-form
    distance ``length - dot < editdist`` (``editdist <= length``)."""
    if engine == "pallas":
        from . import pallas_gpu
        return pallas_gpu.count_within(q_feat, db_feat, length=length,
                                       editdist=editdist)
    nq = q_feat.shape[0]
    q_tile, db_tile = _xla_tiles(nq, db_feat.shape[0])
    q = jnp.pad(q_feat, ((0, (-nq) % q_tile), (0, 0)))
    return _count_all(q, db_feat, editdist=editdist, length=length,
                      db_tile=db_tile, q_tile=q_tile)[:nq]


def topk_feats(q_feat, db_feat, nd: int, *, k: int, length: int,
               engine: str):
    """(nq, k) int32 device keys of the k nearest of the first ``nd``
    database rows, ascending; ``INF_KEY`` past the database."""
    if engine == "pallas":
        from . import pallas_gpu
        return pallas_gpu.topk_keys(q_feat, db_feat, jnp.int32(nd), k=k,
                                    length=length)
    nq = q_feat.shape[0]
    q_tile, db_tile = _xla_tiles(nq, db_feat.shape[0])
    q = jnp.pad(q_feat, ((0, (-nq) % q_tile), (0, 0)))
    return _topk_all(q, db_feat, jnp.int32(nd), jnp.int32(0), k=k,
                     length=length, db_tile=db_tile, q_tile=q_tile)[:nq]


def hamming_topk(q_onehot: np.ndarray, db_onehot: np.ndarray, k: int,
                 length: int, *, db_tile: int = DB_TILE, q_tile: int = 2048,
                 idx_offset: int = 0):
    """Exact k smallest Hamming distances of every query against the
    database, from host one-hot matrices (the XLA engine; tests' and
    tools' reference).

    Returns:
      (dists, idx): two (nq, k) int32 arrays, ascending by (dist, idx).
      Entries beyond the database size are (-1, -1).
    """
    nd = db_onehot.shape[0]
    if nd > MAX_DB:
        raise ValueError(f"database shard too large ({nd} > {MAX_DB}); shard it")
    nq = q_onehot.shape[0]
    k_eff = min(k, nd)
    db_tile = fit_tile(db_tile, nd)
    q_tile = fit_tile(q_tile, nq)
    db_dev = jnp.asarray(_pad_rows(db_onehot, db_tile), dtype=jnp.bfloat16)
    q_dev = jnp.asarray(_pad_rows(q_onehot, q_tile), dtype=jnp.bfloat16)
    keys = _topk_all(q_dev, db_dev, jnp.int32(nd), jnp.int32(idx_offset),
                     k=k_eff, length=length, db_tile=db_tile, q_tile=q_tile)
    return keys_to_neighbors(np.asarray(keys)[:nq], nd + idx_offset, k)
