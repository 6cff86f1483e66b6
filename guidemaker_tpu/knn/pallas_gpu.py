"""Hamming counting and top-k kernels for NVIDIA GPUs (Pallas, Triton route).

Both kernels stream an int8 one-hot database through a tensor-core
product ``matches = q @ db.T`` (int32 accumulation: the operands are 0/1
and a row sum is at most the feature width, so every value is exact) and
reduce each (query block x database block) tile in registers.  No
per-pair value is ever written to device memory:

* counting keeps ``count(matches > length - editdist)`` per query row;
* top-k keeps, per query row, the k smallest packed ``(dist << 24) | idx``
  keys seen so far, and touches that set only while the tile still holds
  a key below the row's current k-th best (rare after the first tiles).

Grid: (query blocks, database splits).  Each program owns one query
block and loops over the database blocks of its split; splits exist only
to fill the card when there are few query blocks, and are summed
(counting) or merged (top-k) outside the kernel.

Padding rows are all-zero one-hots: a padded database row has
``dist == length`` (never below a threshold ``editdist <= length``) and an
index ``>= nd``, which the top-k wrapper masks after the merge — a padded
row can never displace a real one, whose key is always smaller.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from .hamming import IDX_BITS, IDX_MASK, INF_KEY, feat_width

#: database rows per loop step, and query rows per program
BLOCK_D = 128
BLOCK_Q_COUNT = 128
BLOCK_Q_TOPK = 64
#: programs to aim for when splitting the database (132 SMs, a few each)
_TARGET_PROGRAMS = 528
#: masked-out key: above every real key and every sentinel
_MASKED = int(np.iinfo(np.int32).max)


def _splits(n_qb: int, n_blk: int):
    """(splits, database blocks per split) for a grid of ``n_qb`` query
    blocks over ``n_blk`` database blocks."""
    n_split = min(n_blk, max(1, -(-_TARGET_PROGRAMS // n_qb)))
    return n_split, -(-n_blk // n_split)


def _layout(q_feat, db_feat, block_q: int):
    """Pad queries and database to whole blocks and the feature width to
    the kernel's; returns (q, db, grid, per_split, kc)."""
    nq, f = q_feat.shape
    fp = feat_width(f)
    nq_pad = -(-nq // block_q) * block_q
    nd_pad = -(-db_feat.shape[0] // BLOCK_D) * BLOCK_D
    q = jnp.pad(q_feat.astype(jnp.int8), ((0, nq_pad - nq), (0, fp - f)))
    db = jnp.pad(db_feat.astype(jnp.int8),
                 ((0, nd_pad - db_feat.shape[0]), (0, fp - f)))
    n_qb, n_blk = nq_pad // block_q, nd_pad // BLOCK_D
    n_split, per_split = _splits(n_qb, n_blk)
    return q, db, (n_qb, n_split), per_split, min(fp, 128)


def _matches(q_ref, db_ref, start, kc: int):
    """(BQ, BLOCK_D) int32 matches of the query block against the database
    rows ``[start, start + BLOCK_D)``, K in ``kc``-wide chunks.  Wide
    features loop over the chunks, so shared memory holds one chunk's
    operands per pipeline stage, not all of them."""
    def chunk(c, acc):
        q = q_ref[:, pl.ds(c * kc, kc)]
        d = db_ref[pl.ds(start, BLOCK_D), pl.ds(c * kc, kc)]
        return acc + jax.lax.dot_general(q, d, (((1,), (1,)), ((), ())),
                                         preferred_element_type=jnp.int32)

    zero = jnp.zeros((q_ref.shape[0], BLOCK_D), jnp.int32)
    n_chunks = q_ref.shape[1] // kc
    if n_chunks == 1:
        return chunk(0, zero)
    return jax.lax.fori_loop(0, n_chunks, chunk, zero)


def _count_kernel(q_ref, db_ref, out_ref, *, thresh, n_blk, per_split, kc):
    s = pl.program_id(1)

    def body(j, cnt):
        blk = s * per_split + j
        start = pl.multiple_of(jnp.minimum(blk, n_blk - 1) * BLOCK_D, BLOCK_D)
        hit = (_matches(q_ref, db_ref, start, kc) > thresh) & (blk < n_blk)
        return cnt + jnp.sum(hit.astype(jnp.int32), axis=1)

    out_ref[...] = jax.lax.fori_loop(
        0, per_split, body, jnp.zeros((q_ref.shape[0],), jnp.int32))


@functools.partial(jax.jit, static_argnames=("length", "editdist",
                                              "interpret"))
def count_within(q_feat, db_feat, *, length: int, editdist: int,
                 interpret: bool = False):
    """(nq,) int32: database rows with ``length - dot(q, db) < editdist``.

    ``q_feat`` (nq, F) and ``db_feat`` (nd, F) are int8 0/1 features of
    the same width; rows and features are padded here to the kernel's
    blocks.  Requires ``editdist <= length``.
    """
    q, db, grid, per_split, kc = _layout(q_feat, db_feat, BLOCK_Q_COUNT)
    kernel = functools.partial(_count_kernel, thresh=length - editdist,
                               n_blk=db.shape[0] // BLOCK_D,
                               per_split=per_split, kc=kc)
    out = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[pl.BlockSpec((BLOCK_Q_COUNT, q.shape[1]),
                               lambda i, s: (i, 0)),
                  pl.BlockSpec(db.shape, lambda i, s: (0, 0))],
        out_specs=pl.BlockSpec((None, BLOCK_Q_COUNT), lambda i, s: (s, i)),
        out_shape=jax.ShapeDtypeStruct((grid[1], q.shape[0]), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="hamming_count",
    )(q, db)
    return out.sum(axis=0)[:q_feat.shape[0]]


def _topk_kernel(q_ref, db_ref, out_ref, *, length, k, n_blk, per_split,
                 kc):
    s = pl.program_id(1)
    bq, kp = out_ref.shape
    col = jax.lax.broadcasted_iota(jnp.int32, (bq, kp), 1)
    # distinct sentinels keep every entry of a row unique, so "the entry
    # equal to the row max" names exactly one slot; slots >= k hold
    # negatives, which are never the max and so never replaced
    best0 = jnp.where(col < k, INF_KEY + col, -1 - col)
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, BLOCK_D), 1)

    def insert(carry):
        best, keys, m = carry
        worst = jnp.max(best, axis=1)
        take = (best == worst[:, None]) & (m < worst)[:, None]
        best = jnp.where(take, m[:, None], best)
        keys = jnp.where(keys == m[:, None], _MASKED, keys)
        return best, keys, jnp.min(keys, axis=1)

    def improves(carry):
        best, _, m = carry
        return jnp.max((m < jnp.max(best, axis=1)).astype(jnp.int32)) > 0

    def body(j, best):
        blk = s * per_split + j
        start = pl.multiple_of(jnp.minimum(blk, n_blk - 1) * BLOCK_D, BLOCK_D)
        dist = length - _matches(q_ref, db_ref, start, kc)
        keys = jnp.where(blk < n_blk, (dist << IDX_BITS) | (start + lane),
                         _MASKED)
        best, _, _ = jax.lax.while_loop(
            improves, insert, (best, keys, jnp.min(keys, axis=1)))
        return best

    out_ref[...] = jax.lax.fori_loop(0, per_split, body, best0)


@functools.partial(jax.jit, static_argnames=("k", "length", "interpret"))
def topk_keys(q_feat, db_feat, nd, *, k: int, length: int,
              interpret: bool = False):
    """(nq, k) int32 packed keys, ascending, of the k nearest of the first
    ``nd`` database rows (Hamming ``length - dot``); ``INF_KEY`` where
    fewer than k rows exist.  Inputs as in :func:`count_within`."""
    nq = q_feat.shape[0]
    kp = 1 << max(1, (k - 1).bit_length())
    q, db, grid, per_split, kc = _layout(q_feat, db_feat, BLOCK_Q_TOPK)
    n_split = grid[1]
    kernel = functools.partial(_topk_kernel, length=length, k=k,
                               n_blk=db.shape[0] // BLOCK_D,
                               per_split=per_split, kc=kc)
    out = pl.pallas_call(
        kernel,
        grid=grid,
        in_specs=[pl.BlockSpec((BLOCK_Q_TOPK, q.shape[1]),
                               lambda i, s: (i, 0)),
                  pl.BlockSpec(db.shape, lambda i, s: (0, 0))],
        out_specs=pl.BlockSpec((None, BLOCK_Q_TOPK, kp),
                               lambda i, s: (s, i, 0)),
        out_shape=jax.ShapeDtypeStruct((n_split, q.shape[0], kp), jnp.int32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="hamming_topk",
    )(q, db)
    keys = out[:, :nq].transpose(1, 0, 2).reshape(nq, n_split * kp)
    keys = jnp.where((keys < 0) | (keys >= INF_KEY)
                     | ((keys & IDX_MASK) >= nd), INF_KEY, keys)
    neg_top, _ = jax.lax.top_k(-keys, k)
    return -neg_top
