"""Exact Levenshtein k-NN: batched DP with a cummin row recurrence.

Replaces the reference's NMSLib ``leven`` space (core.py:459-467).  The
classic DP has a sequential dependency along the row (``D[i,j-1] + 1``);
we break it with the standard prefix-min identity::

    E[j]   = min(D[i-1, j] + 1, D[i-1, j-1] + cost(i, j))   # vectorizable
    D[i,j] = min_{m <= j} (E[m] + (j - m))                   # cummin form
           = cummin_j(E[j] - j) + j

so each DP row is pure elementwise + ``lax.cummin`` work,
vectorized over a (query_tile x db_tile) block of guide pairs.  The scan
over rows has ``L`` (guide length, <= 27) steps.

All guides in a run share one length (the reference's ``check_target``
enforces ``len == target_len``, core.py:127-140), which keeps shapes static.
"""
from __future__ import annotations

import functools
import logging

import jax
import jax.numpy as jnp
import numpy as np

from .hamming import (INF_KEY, _merge_topk, _pad_rows, bucket_rows,
                      count_feats, db_rows, onehot_on_device, pack_keys,
                      pad_code_rows, unpack_keys)

logger = logging.getLogger(__name__)


@functools.partial(jax.jit, static_argnames=("length",))
def leven_block(qc: jnp.ndarray, dc: jnp.ndarray, *, length: int) -> jnp.ndarray:
    """Full Levenshtein distance for every (query, db) pair in the block.

    qc: (tq, L) uint8 codes; dc: (td, L) uint8 codes -> (tq, td) int32.
    """
    tq, td = qc.shape[0], dc.shape[0]
    jcol = jax.lax.broadcasted_iota(jnp.int32, (1, 1, length + 1), 2)
    d_prev = jnp.broadcast_to(jcol, (tq, td, length + 1)).astype(jnp.int32)

    # rows unrolled (length <= 27 is static): flat straight-line HLO
    # compiles faster than a nested lax.scan
    for i in range(length):
        qchar = qc[:, i:i + 1]                                  # (tq, 1)
        cost = (qchar[:, None, :] != dc[None, :, :]).astype(jnp.int32)
        sub = d_prev[..., :-1] + cost
        dele = d_prev[..., 1:] + 1
        e_tail = jnp.minimum(sub, dele)
        e_head = jnp.full((tq, td, 1), i + 1, dtype=jnp.int32)
        e = jnp.concatenate([e_head, e_tail], axis=-1)
        d_prev = jax.lax.cummin(e - jcol, axis=2) + jcol
    return d_prev[..., -1]


@functools.partial(jax.jit, static_argnames=("length", "clean"))
def leven_block_myers(qc: jnp.ndarray, dc: jnp.ndarray, *,
                      length: int, clean: bool = True) -> jnp.ndarray:
    """Bit-parallel Levenshtein (Myers 1999) for every (query, db) pair.

    Each pair's whole DP column state lives in ONE int32 (guide length
    <= 31 bits); the vertical delta vectors Pv/Mv advance one text
    character per step.  Op-golfed for elementwise integer units:

    * mask-free recurrence — carries/shifts only move bits upward and
      every bitwise op is positionwise, so bits < m stay exact with
      garbage above them; all ``& mask`` ops are dropped (the final
      popcounts mask once);
    * xor-form ``eq`` from two per-query bitplanes: 3 wide ops
      (2 xor + and) instead of 3 lane-broadcast selects + bool casts;
    * no per-step score tracking: D[m][n] = n + pop(Pv) - pop(Mv) over
      the pattern bits of the FINAL vertical deltas (column-n telescoping
      sum), two ``population_count`` ops at the end.

    ``clean=True`` (the fast path) requires codes < 4 on both sides —
    scan.py guarantees ACGT-pure targets and the control sampler only
    draws codes 0-3; callers with possibly-ambiguous codes (N >= 4) pass
    ``clean=False``, which adds a validity plane so INVALID matches
    nothing on either side (one-hot semantics: N != N).
    qc: (tq, L) uint8 pattern codes; dc: (td, L) uint8 text codes
    -> (tq, td) int32 edit distances.
    """
    tq, td = qc.shape[0], dc.shape[0]
    m = length
    mask = jnp.int32((1 << m) - 1)
    # per-query 2-bit code bitplanes: bit i of b0q = low bit of code i
    pos = (jnp.int32(1) << jnp.arange(m, dtype=jnp.int32))      # (L,)
    c32 = qc[:, :m].astype(jnp.int32)
    b0q = jnp.sum(jnp.where((c32 & 1) == 1, pos[None, :], 0),
                  axis=1).astype(jnp.int32)[:, None]             # (tq, 1)
    b1q = jnp.sum(jnp.where((c32 >> 1) == 1, pos[None, :], 0),
                  axis=1).astype(jnp.int32)[:, None]
    if not clean:
        vq = jnp.sum(jnp.where(c32 < 4, pos[None, :], 0),
                     axis=1).astype(jnp.int32)[:, None]          # (tq, 1)

    pv = jnp.full((tq, td), -1, dtype=jnp.int32)
    mv = jnp.zeros((tq, td), dtype=jnp.int32)

    for j in range(m):
        c = dc[:, j].astype(jnp.int32)[None, :]                  # (1, td)
        s0 = (c & 1) - 1          # 0 where text bit set, -1 otherwise
        s1 = ((c >> 1) & 1) - 1   # (row-sized, negligible)
        eq = (b0q ^ s0) & (b1q ^ s1)                             # (tq, td)
        if not clean:
            # zero match bits for INVALID query positions (vq) and for
            # an INVALID text char (row mask t = -1 where c >= 4)
            eq = eq & (vq & ~(-((c >> 2) & 1)))
        xv = eq | mv
        xh = (((eq & pv) + pv) ^ pv) | eq
        ph = mv | ~(xh | pv)
        mh = pv & xh
        ph = (ph << 1) | 1
        mh = mh << 1
        pv = mh | ~(xv | ph)
        mv = ph & xv
    return (jnp.int32(m) + jax.lax.population_count(pv & mask)
            - jax.lax.population_count(mv & mask))


@functools.partial(jax.jit, static_argnames=("k", "length", "db_tile",
                                              "engine", "clean"))
def _topk_tiles_leven(qc, db_codes, db_n, idx_offset, *, k, length, db_tile,
                      engine="myers", clean=True):
    """Running top-k of packed (dist, idx) keys over Levenshtein db tiles."""
    n_tiles = db_codes.shape[0] // db_tile
    tq = qc.shape[0]
    init = jnp.full((tq, k), INF_KEY, dtype=jnp.int32)
    lane = jax.lax.broadcasted_iota(jnp.int32, (1, db_tile), 1)
    if engine == "myers":
        block = functools.partial(leven_block_myers, clean=clean)
    else:
        block = leven_block

    def body(best, t):
        tile = jax.lax.dynamic_slice_in_dim(db_codes, t * db_tile, db_tile)
        dist = block(qc, tile, length=length)
        gidx = t * db_tile + lane
        keys = jnp.where(gidx < db_n, pack_keys(dist, gidx + idx_offset), INF_KEY)
        if k <= 8:
            # k-round min-extraction: packed keys are unique (distinct
            # idx bits), so masking the exact minimum each round yields
            # the tile's k smallest in ~3k elementwise ops per element,
            # cheaper than a full lax.top_k over (tq, db_tile + k)
            cand = []
            kk = keys
            for _ in range(min(k, db_tile)):
                m = jnp.min(kk, axis=1)
                cand.append(m)
                kk = jnp.where(kk == m[:, None], INF_KEY, kk)
            keys = jnp.stack(cand, axis=1)
        return _merge_topk(best, keys, k), None

    best, _ = jax.lax.scan(body, init, jnp.arange(n_tiles, dtype=jnp.int32))
    return best


@functools.partial(jax.jit, static_argnames=("k", "length", "db_tile",
                                              "q_tile", "engine", "clean"))
def _topk_scan_leven(q_pad, db_codes, db_n, idx_offset, *, k, length,
                     db_tile, q_tile, engine="myers", clean=True):
    """Single-dispatch driver: lax.scan over query tiles around the db-tile
    running top-k — one device program for the whole query chunk."""
    n_qt = q_pad.shape[0] // q_tile
    qt = q_pad.reshape(n_qt, q_tile, length)

    def step(_, qtile):
        return None, _topk_tiles_leven(qtile, db_codes, db_n, idx_offset,
                                       k=k, length=length, db_tile=db_tile,
                                       engine=engine, clean=clean)

    _, keys = jax.lax.scan(step, None, qt)
    return keys.reshape(n_qt * q_tile, k)


#: max queries per full-DP device dispatch: bounds the size of one
#: device program (and of its (chunk, k) key block) independently of
#: the query count, so one compiled shape serves any large query set.
_TOPK_CHUNK = 8192


def leven_topk(q_codes: np.ndarray, db_codes: np.ndarray, k: int, *,
               db_tile: int = 4096, q_tile: int = 1024, idx_offset: int = 0,
               db_dev=None, chunk: int = _TOPK_CHUNK, engine: str = "myers"):
    """Exact k smallest Levenshtein distances per query (see hamming_topk).

    Queries are dispatched in ``chunk``-row slices (pow2-bucketed, so the
    program set stays logarithmic); pass a pre-transferred ``db_dev``
    (from ``jnp.asarray(_pad_rows(db_codes, db_tile))``) to reuse a
    device-resident database across calls.  ``engine`` selects the block
    kernel: "myers" (bit-parallel, the default) or "dp" (the cummin row
    recurrence, kept as the cross-check oracle).
    """
    nq, nd = q_codes.shape[0], db_codes.shape[0]
    length = q_codes.shape[1]
    if length > 31 and engine == "myers":
        engine = "dp"   # Myers packs the DP column into one int32
    # ambiguity gate: the golfed Myers fast path assumes codes < 4 (true
    # for all scan-produced targets); ambiguous inputs take the masked
    # variant where INVALID matches nothing (one-hot semantics)
    clean = not (bool((q_codes >= 4).any()) or bool((db_codes >= 4).any()))
    k_eff = min(k, nd)
    db_tile = min(db_tile, max(128, 1 << (int(nd - 1).bit_length())))

    if db_dev is None:
        db_dev = jnp.asarray(_pad_rows(db_codes, db_tile))
    devs, ms = [], []
    for lo in range(0, nq, chunk):
        qc = q_codes[lo:lo + chunk]
        m = qc.shape[0]
        qt = min(q_tile, max(128, 1 << (int(m - 1).bit_length())))
        # pow2-bucketed query padding: novel query-batch sizes otherwise
        # compile a fresh program each.  Multi-chunk workloads pad the
        # TAIL chunk to the full chunk size too: one program shape then
        # serves any large query set (and the phase-2 prewarm compiles it)
        if nq > chunk:
            # clamp the tile to the chunk (a caller-supplied chunk below
            # q_tile otherwise yields a zero-tile reshape in the scan)
            # and pad every chunk to a whole number of tiles — one fixed
            # shape for all chunks regardless of the chunk/q_tile ratio
            qt = min(q_tile, chunk)
            q_pad = _pad_rows(qc, -(-chunk // qt) * qt)
        else:
            q_pad = _pad_rows(qc, bucket_rows(m, qt))
        # dispatch only — every chunk queues on the device; ONE batched
        # fetch below drains the tiny (chunk, k) key blocks, so host
        # prep for chunk i+1 overlaps chunk i's DP
        devs.append(_topk_scan_leven(
            jnp.asarray(q_pad), db_dev, jnp.int32(nd),
            jnp.int32(idx_offset), k=k_eff, length=length,
            db_tile=db_tile, q_tile=qt, engine=engine, clean=clean))
        ms.append(m)
    outs = [np.asarray(o)[:m] for o, m in zip(jax.device_get(devs), ms)]
    out = np.concatenate(outs) if outs else np.empty((0, k_eff), np.int32)

    dist, idx = unpack_keys(out)
    if k_eff < k:
        pad = np.full((nq, k - k_eff), -1, dtype=np.int32)
        dist = np.concatenate([dist, pad], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return dist, idx


# ---------------------------------------------------------------------------
# Genome-scale Levenshtein retention: matrix-product prefilter + banded-DP
# verification
#
# The reference handles million-guide `leven` runs through one NMSLib index
# (core.py:459-467).  Exact brute-force DP over all pairs is elementwise
# work (~3.4k ops/pair) — 1e12 pairs would take hours.  Retention, however,
# only needs "is the 2nd-nearest neighbor at distance >= e", and that
# decision can ride the tensor cores:
#
# * e == 2 (the shipped default): between EQUAL-LENGTH strings a single
#   length-preserving edit must be a substitution, so leven < 2 <=>
#   hamming < 2 and retention IS the plain Hamming counting pass.
#
# * e == 3: exact decomposition — every equal-length cost-<=2 script is
#   either <=2 substitutions (hamming <= 2: one counting pass) or one
#   deletion + one insertion, which holds iff the two strings share a
#   length-(L-1) deletion variant (SymSpell-style sorted join; see
#   _delset_partner_device).  No DP, no filter tiers.
#
# * e >= 4: the positional q-gram lemma.  If leven(a, b) <= t (t = e-1),
#   at most t*q of a's (L-q+1) q-grams overlap an edit, and every
#   surviving gram appears in b within +-t gram positions (the alignment
#   never leaves the +-t diagonal band).  With q = 3 the gram one-hot is
#   exact in 64 channels, so
#
#     dot(gram(a), dil_gram_t(b)) >= (L-q+1) - t*q
#
#   i.e. under the standard counting pass (length = L-q+1,
#   editdist = t*q+1) the pair's pseudo-distance is < t*q+1.  One int8
#   product over (L-2)*64 features per pair, evaluated by the same
#   counting engine as Hamming retention.  (Base-level +-t dilation —
#   match each CHARACTER within a window — degenerates for t >= 2 on
#   20-mers: random pairs match ~76% of characters within +-2, so
#   virtually every pair passed; 3-gram matches are ~7.5% per position
#   and the filter stays sharp through t = 4.)
#
# The gram filter is sound (never misses a true leven < e pair) but not
# exact; queries with >= 2 filter hits are verified by a banded DP over
# their top-_FILTER_K candidate pairs (a proven close neighbor decides
# FAIL exactly even when the candidate list overflows), a second-direction
# gram count prunes overflow queries (count <= 1 proves PASS), and the
# residue falls back to exact chunked full-DP k=2 queries.
# ---------------------------------------------------------------------------

#: filter top-k candidate budget.  Queries with <= this many filter
#: candidates are decided exactly by the banded-DP tier; more fall
#: through to the second-direction prune / full-DP fallback.  64 covers
#: the typical shift-sibling candidate mass of PAM-dense genome regions
#: (banded verification is ~180 elementwise ops/pair).  Extraction is
#: the XLA lax.top_k merge (hamming._topk_all).
_FILTER_K = 64


#: q-gram width for the t >= 2 retention filter.  4**3 = 64 channels keep
#: the gram one-hot EXACT (no hashing) and the feature matrix at
#: (L-2)*64 int8 features (1152 for 20-mers).
GRAM_Q = 3


def _filter_feats(codes: np.ndarray, t: int, side: str) -> np.ndarray:
    """Positional 3-gram filter features: queries carry the plain gram
    one-hot, database rows the +-t gram-position-dilated one, so
    dot(q, db) counts query grams present in the database guide within a
    +-t window.  (Host/numpy variant — the soundness oracle, independent
    of the production device builder :func:`_gram_feats_on_device`.)"""
    n, length = codes.shape
    glen = length - GRAM_Q + 1
    a = codes.astype(np.int64)
    g = a[:, :glen] * 16 + a[:, 1:glen + 1] * 4 + a[:, 2:glen + 2]
    valid = ((codes[:, :glen] < 4) & (codes[:, 1:glen + 1] < 4)
             & (codes[:, 2:glen + 2] < 4))
    oh = np.zeros((n, glen, 64), dtype=np.int8)
    np.put_along_axis(oh, np.where(valid, g, 0)[..., None],
                      valid[..., None].astype(np.int8), axis=2)
    out = oh
    tt = 0 if side == "q" else t
    for s in range(1, tt + 1):
        fwd = np.zeros_like(oh)
        fwd[:, s:] = oh[:, :-s]
        back = np.zeros_like(oh)
        back[:, :-s] = oh[:, s:]
        out = np.maximum(out, np.maximum(fwd, back))
    return out.reshape(n, glen * 64)


@functools.partial(jax.jit, static_argnames=("t",))
def _gram_feats_on_device(codes, *, t):
    """uint8 codes -> lane-padded int8 positional 3-gram one-hot,
    OR-dilated over a +-t gram-position window (t=0 gives the plain gram
    one-hot for the query side).

    The q-gram lemma drives the t >= 2 filter: <= t edits destroy at
    most t*q of a's L-q+1 grams, and every surviving gram appears in b
    within +-t positions — so leven(a,b) <= t implies
    dot(gram(a), dil_gram_t(b)) >= (L-q+1) - t*q.  Base-level +-t
    dilation degenerates on 20-mers at t >= 2 (random pairs match ~76%
    of positions within a +-2 window, so nearly every pair passed);
    3-gram positional matches are ~7.5% per position for random pairs,
    keeping the filter sharp through t=4.  Grams touching an INVALID
    (padding) code one-hot to zero."""
    n, length = codes.shape
    glen = length - GRAM_Q + 1
    g = (codes[:, :glen].astype(jnp.int32) * 16
         + codes[:, 1:glen + 1].astype(jnp.int32) * 4
         + codes[:, 2:glen + 2].astype(jnp.int32))
    valid = ((codes[:, :glen] < 4) & (codes[:, 1:glen + 1] < 4)
             & (codes[:, 2:glen + 2] < 4))
    oh = jax.nn.one_hot(g, 64, dtype=jnp.int8) * valid[..., None].astype(jnp.int8)
    dil = oh
    for s in range(1, t + 1):
        fwd = jnp.pad(oh, ((0, 0), (s, 0), (0, 0)))[:, :glen]
        back = jnp.pad(oh, ((0, 0), (0, s), (0, 0)))[:, s:]
        dil = jnp.maximum(dil, jnp.maximum(fwd, back))
    flat = dil.reshape(n, glen * 64)
    pad = -(glen * 64) % 128
    if pad:
        flat = jnp.pad(flat, ((0, 0), (0, pad)))
    return flat


def _del_variants_packed(codes: np.ndarray) -> np.ndarray:
    """(n, L) uint8 codes -> (n, L) int64: variant ``d`` is the string
    with position ``d`` deleted, packed 2 bits/char (requires codes < 4
    and L <= 31, both guaranteed for guide targets)."""
    n, L = codes.shape
    c = codes.astype(np.int64)
    w = np.int64(1) << (2 * np.arange(L, dtype=np.int64))
    pref = np.zeros((n, L + 1), np.int64)
    np.cumsum(c * w, axis=1, out=pref[:, 1:])
    full = pref[:, L:L + 1]
    # V[:, d] = (chars before d at their weights) + (chars after d
    # shifted down one position, i.e. divided by 4 — exact: each term
    # has weight 4^k with k >= d+1 >= 1)
    return pref[:, :L] + ((full - pref[:, 1:]) >> 2)


def _delset_partner_mask(codes: np.ndarray) -> np.ndarray:
    """(n,) bool — does guide ``i`` share a deletion variant with ANY
    other guide?  (SymSpell-style deletion neighborhood: for
    equal-length strings this is exactly the one-deletion-one-insertion
    case of leven <= 2.)

    Sort-based, no hashing: pack each of the n*L length-(L-1) variants
    into an int64, sort once, and mark every variant run that contains
    >= 2 distinct owners.  The tests' oracle for the production
    :func:`_delset_partner_device`.
    """
    n, L = codes.shape
    V = _del_variants_packed(codes).ravel()
    owners = np.repeat(np.arange(n, dtype=np.int64), L)
    ob = max(int(n - 1).bit_length(), 1)
    if 2 * (L - 1) + ob <= 63:
        # composite (variant, owner) key: one flat int64 sort
        keys = (V << ob) | owners
        keys.sort()
        v_s = keys >> ob
        own_s = keys & ((np.int64(1) << ob) - 1)
    else:
        order = np.argsort(V, kind="stable")
        v_s, own_s = V[order], owners[order]
    new_run = np.empty(v_s.size, dtype=bool)
    new_run[0] = True
    np.not_equal(v_s[1:], v_s[:-1], out=new_run[1:])
    starts = np.flatnonzero(new_run)
    run_multi = (np.minimum.reduceat(own_s, starts)
                 != np.maximum.reduceat(own_s, starts))
    lengths = np.diff(np.append(starts, v_s.size))
    partner = np.zeros(n, dtype=bool)
    partner[own_s[np.repeat(run_multi, lengths)]] = True
    return partner


@functools.partial(jax.jit, static_argnames=("length",))
def _delset_partner_device(codes, *, length):
    """Device twin of :func:`_delset_partner_mask`: (n, L) uint8 codes ->
    (n,) bool partner mask, entirely on the accelerator.

    The production path of the e=3 retention decision; the host
    version is the tests' oracle.  JAX runs with x64 disabled, so the
    packed length-(L-1) variant is split into a (hi, lo) int32
    pair — lo wraps mod 2^32, which is still injective per variant
    (the true low half is exactly 32 bits) — and grouped with ONE
    lexicographic ``lax.sort`` over (hi, lo) with the owner id as
    payload.  Every adjacent sorted pair with an equal variant and a
    different owner flags both owners: each maximal same-owner block in
    a multi-owner run borders a different owner, so all partners are
    flagged (and single-owner runs never are).
    """
    n = codes.shape[0]
    L = length
    glen = L - 1
    # variant (i, d) = row i with position d deleted: gather via the
    # static (L, glen) index table idx[d, j] = j + (j >= d)
    j = np.arange(glen)
    idx = jnp.asarray((j[None, :] + (j[None, :] >= np.arange(L)[:, None]))
                      .astype(np.int32))
    var = codes[:, idx].astype(jnp.int32)            # (n, L, glen)
    lo_w = jnp.asarray([jnp.int32(1) << (2 * k) for k in range(min(16, glen))])
    lo = jnp.sum(var[..., :16] * lo_w, axis=-1)      # wraps mod 2^32: ok
    if glen > 16:
        hi_w = jnp.asarray([jnp.int32(1) << (2 * (k - 16))
                            for k in range(16, glen)])
        hi = jnp.sum(var[..., 16:] * hi_w, axis=-1)
    else:
        hi = jnp.zeros_like(lo)
    owners = (jax.lax.broadcasted_iota(jnp.int32, (n, L), 0)).reshape(-1)
    hi, lo = hi.reshape(-1), lo.reshape(-1)
    hi_s, lo_s, own_s = jax.lax.sort((hi, lo, owners), num_keys=2)
    same = (hi_s[1:] == hi_s[:-1]) & (lo_s[1:] == lo_s[:-1])
    flag = (same & (own_s[1:] != own_s[:-1])).astype(jnp.int32)
    part = jnp.zeros((n,), jnp.int32)
    part = part.at[own_s[:-1]].max(flag)
    part = part.at[own_s[1:]].max(flag)
    return part.astype(jnp.bool_)


def _match_rows(q_codes: np.ndarray, db_codes: np.ndarray) -> np.ndarray:
    """Row index in ``db_codes`` of each ``q_codes`` row (2-bit packed
    exact match; rows absent from the db map to row 0 — callers hold the
    driver precondition that every query is a db member)."""
    L = q_codes.shape[1]
    w = np.int64(1) << (2 * np.arange(L, dtype=np.int64))
    dbp = db_codes.astype(np.int64) @ w
    qp = q_codes.astype(np.int64) @ w
    order = np.argsort(dbp, kind="stable")
    pos = np.searchsorted(dbp[order], qp)
    pos = np.clip(pos, 0, dbp.size - 1)
    idx = order[pos]
    idx[dbp[idx] != qp] = 0
    return idx


_BIG = np.int32(1 << 20)


@functools.partial(jax.jit, static_argnames=("t", "length"))
def banded_leven_pairs(a: jnp.ndarray, b: jnp.ndarray, *, t: int,
                       length: int) -> jnp.ndarray:
    """Banded Levenshtein for row-paired codes: (n, L) x (n, L) -> (n,).

    Exact whenever the true distance is <= t; anything larger returns
    t + 1 (a path with > t edits must leave the +-t diagonal band, so the
    band bound is itself sound).  Elementwise only: w = 2t+1 lanes per pair,
    cummin row recurrence as in leven_block.
    """
    n = a.shape[0]
    w = 2 * t + 1
    offs = jnp.arange(-t, t + 1, dtype=jnp.int32)          # (w,)
    oidx = jnp.arange(w, dtype=jnp.int32)
    row = jnp.where(offs >= 0, offs, _BIG)
    B = jnp.broadcast_to(row, (n, w)).astype(jnp.int32)    # D[0][j]

    for i in range(1, length + 1):
        j = i + offs                                       # (w,) col per lane
        in_band = (j >= 0) & (j <= length)
        # substitution: B[o] + (a[i-1] != b[j-1]); j==0 handled below
        bj = jnp.take(b, jnp.clip(j - 1, 0, length - 1), axis=1)  # (n, w)
        cost = (a[:, i - 1:i] != bj).astype(jnp.int32)
        sub = B + cost
        # deletion (consume a char): D[i-1][j] = B[o+1]
        dele = jnp.concatenate(
            [B[:, 1:], jnp.full((n, 1), _BIG, jnp.int32)], axis=1) + 1
        E = jnp.minimum(sub, dele)
        E = jnp.where(j == 0, jnp.int32(i), E)             # D[i][0] = i
        E = jnp.where(in_band, E, _BIG)
        # insertion closure along the row: D[i][j] = min_{m<=j} E[m]+(j-m)
        B = jax.lax.cummin(E - oidx, axis=1) + oidx
        B = jnp.where(in_band, B, _BIG)
    return jnp.minimum(B[:, t], t + 1)                     # o=0 -> j=L


def leven_pass_filter(q_codes: np.ndarray, db_codes: np.ndarray,
                      editdist: int, *, engine: str = "xla",
                      filter_k: int = _FILTER_K, mesh=None) -> np.ndarray:
    """(nq,) bool — is each query's 2nd-nearest Levenshtein neighbor at
    distance >= editdist?  Requires the driver's counting preconditions
    (deduplicated database, every query a member).

    e == 2 is decided by one plain Hamming counting pass (exact: a single
    length-preserving edit must be a substitution).  e == 3 is decided
    exactly by hamming<=2 counting OR a deletion-variant join (see the
    design block above).  e >= 4 runs the tiered positional 3-gram
    filter — gram counting, banded-DP verification of candidate lists,
    second-direction gram prune, exact chunked full-DP residue.  All
    feature matrices are built on device from 2-bit codes.

    ``engine`` evaluates the counting passes (see
    :func:`.hamming.count_feats`).  ``mesh``: when given, EVERY tier runs
    over the mesh: the counting passes shard database features over
    ``d`` and queries over ``q`` with one ``psum`` merge; candidate
    extraction uses the sharded top-k; banded verification shards its
    pair rows over all devices (sharded.sharded_banded_pairs, no
    collectives); and the full-DP residue runs the sharded Levenshtein
    top-k.
    """
    nq, length = q_codes.shape
    nd = db_codes.shape[0]
    e = int(editdist)
    if e <= 1:
        # dist < 1 means identical; dedup + membership make self the only
        # such hit, so every query passes (e == 0 is vacuous, as in the
        # reference threshold core.py:517-522)
        return np.ones(nq, dtype=bool)
    t = e - 1
    # the same padded row count as the driver's resident database, so
    # the e=2/e=3 counting program is the Hamming retention program
    db_pad = jnp.asarray(pad_code_rows(db_codes, db_rows(nd)))
    if q_codes is not db_codes and q_codes.shape == db_codes.shape \
            and np.array_equal(q_codes, db_codes):
        # all-vs-all by value (the pipeline re-encodes its query column,
        # so identity never triggers): reuse the database features
        q_codes = db_codes
    q_pad = (db_pad if q_codes is db_codes
             else jnp.asarray(pad_code_rows(q_codes, bucket_rows(nq, 256))))

    def count(q_feat, db_feat, *, flen, edist):
        if mesh is not None:
            from .sharded import sharded_hamming_count
            return sharded_hamming_count(q_feat, db_feat, edist, flen,
                                         mesh=mesh, engine=engine)
        return np.asarray(count_feats(q_feat, db_feat, length=flen,
                                      editdist=edist, engine=engine))

    if e in (2, 3):
        db_feat = onehot_on_device(db_pad)
        q_feat = db_feat if q_codes is db_codes else onehot_on_device(q_pad)
        counts = count(q_feat, db_feat, flen=length, edist=e)[:nq]
        if e == 2:
            # between EQUAL-LENGTH strings a single length-preserving edit
            # must be a substitution: leven < 2 <=> hamming < 2
            return counts <= 1
    if e == 3 and length <= 31:
        # every cost-<=2 script between equal-length strings is <= 2
        # substitutions (the hamming < 3 count above) or one deletion +
        # one insertion, which holds iff the two strings share a
        # length-(L-1) deletion variant
        partner = np.asarray(_delset_partner_device(
            jnp.asarray(db_codes), length=length))
        if q_codes is db_codes:
            q_partner = partner
        else:
            q_partner = partner[_match_rows(q_codes, db_codes)]
        return (counts <= 1) & ~q_partner
    # e >= 4: positional q-gram filter (see _gram_feats_on_device).  A
    # pair is a candidate iff >= (glen - t*q) of the query's 3-grams
    # appear in the database guide within +-t gram positions, i.e. the
    # counting pass's pseudo-dist (glen - dot) is < t*q + 1.
    glen = length - GRAM_Q + 1
    p_edit = t * GRAM_Q + 1
    if glen - t * GRAM_Q < 2 or p_edit > glen:
        # threshold too large for the gram bound (degenerate on short
        # guides): exact chunked full-DP for everything
        d2, _ = leven_topk(q_codes, db_codes, 2)
        return (d2[:, 1] >= 0) & (d2[:, 1] >= e)
    db_feat = _gram_feats_on_device(db_pad, t=t)
    # all-vs-all: plain gram one-hot of the same padded codes (padding
    # rows' counts are sliced off below)
    q_feat = _gram_feats_on_device(q_pad, t=0)
    counts = count(q_feat, db_feat, flen=glen, edist=p_edit)[:nq]
    passed = counts <= 1
    k_eff = min(filter_k, nd)

    def _close_via_topk(idxs, qf_dev, qf_pos, df_dev):
        """For queries ``idxs`` (rows ``qf_pos`` of the feature array
        ``qf_dev``): banded-verify their ``k_eff`` smallest pseudo-dist
        candidates against ``df_dev``.  Returns (nq,) bool — does the
        query have a *proven* non-self Levenshtein-<e neighbor among
        them?  Exhaustive (hence an exact retention decision) whenever
        the query's candidate count is <= k_eff.

        Candidate extraction is the XLA bf16 product + lax.top_k merge
        (hamming._topk_all; k_eff is up to 64).  With a ``mesh``,
        extraction runs sharded and the banded verification shards
        row-wise over every device (sharded.sharded_banded_pairs).
        """
        if mesh is not None:
            from .sharded import sharded_hamming_topk
            _, cand = sharded_hamming_topk(
                jnp.take(qf_dev, jnp.asarray(qf_pos), axis=0), df_dev,
                k_eff, glen, mesh=mesh)
            # padded database rows must never become candidates
            cand = np.where(cand < nd, cand, -1)
        else:
            from .hamming import _topk_all
            df_bf = df_dev.astype(jnp.bfloat16)
            # chunked dispatches bound the (chunk, k) key block and the
            # per-dispatch working set at any candidate-set size
            chunk = 65536
            cand_parts = []
            for lo in range(0, idxs.size, chunk):
                pos = qf_pos[lo:lo + chunk]
                qa_feat = jnp.take(qf_dev, jnp.asarray(pos),
                                   axis=0).astype(jnp.bfloat16)
                na_pad = bucket_rows(pos.size, 256)
                if qa_feat.shape[0] < na_pad:
                    qa_feat = jnp.pad(
                        qa_feat, ((0, na_pad - qa_feat.shape[0]), (0, 0)))
                keys = _topk_all(qa_feat, df_bf, jnp.int32(nd), jnp.int32(0),
                                 k=k_eff, length=glen,
                                 db_tile=min(db_feat.shape[0], 2048),
                                 q_tile=256)
                cand_parts.append(np.asarray(keys[:pos.size, :k_eff]))
            _, cand = unpack_keys(np.concatenate(cand_parts))
        qa = np.repeat(q_codes[idxs], k_eff, axis=0)
        ca = db_codes[np.clip(cand, 0, nd - 1)].reshape(-1, length)
        n_pairs = qa.shape[0]
        if mesh is not None:
            from .sharded import sharded_banded_pairs
            bd = sharded_banded_pairs(qa, ca, t=t, length=length, mesh=mesh)
        else:
            # pow2-bucketed pair batch: every novel batch size would
            # otherwise compile a fresh banded program (INVALID padding
            # rows compare equal -> dist 0, sliced off below)
            qa = pad_code_rows(qa, bucket_rows(n_pairs, 128))
            ca = pad_code_rows(ca, qa.shape[0])
            bd = np.asarray(banded_leven_pairs(
                jnp.asarray(qa), jnp.asarray(ca), t=t,
                length=length))[:n_pairs]
        bd = bd[:n_pairs].reshape(idxs.size, k_eff)
        # dist 0 <=> identical <=> self (db is deduplicated; queries are
        # members); any other candidate closer than e fails retention
        return ((bd > 0) & (bd < e) & (cand >= 0)).any(axis=1)

    todo = np.flatnonzero(counts >= 2)
    logger.debug("leven filter tier sizes: %d queries, %d ambiguous "
                 "(direction-1 counts max %d)", nq, todo.size,
                 int(counts.max(initial=0)))
    if todo.size:
        # Tier 2 — banded verification of the direction-1 candidates.
        # counts <= k_eff: the list is exhaustive, decision is exact.
        # counts > k_eff: a proven close neighbor still decides FAIL
        # exactly (fail-fast for repeat-cluster members, which dominate
        # the overflow set in real genomes).
        close1 = _close_via_topk(todo, q_feat, todo, db_feat)
        complete1 = counts[todo] <= k_eff
        passed[todo] = np.where(complete1, ~close1, passed[todo])
        passed[todo[close1]] = False
        rest = todo[~complete1 & ~close1]
        if rest.size:
            # Tier 3 — second-direction counting prune (the gram lemma is
            # symmetric: db-side surviving grams appear in the query
            # within +-t, so dot(dil_gram(q), gram(db)) >= glen - t*q is
            # an equally sound filter): any true close pair is counted in
            # BOTH directions, so a direction-2 count <= 1 proves PASS
            # even when direction 1 overflowed.
            db_oh = _gram_feats_on_device(db_pad, t=0)
            rest_pad = pad_code_rows(q_codes[rest],
                                     bucket_rows(rest.size, 256))
            q_dil = _gram_feats_on_device(jnp.asarray(rest_pad), t=t)
            counts2 = count(q_dil, db_oh, flen=glen,
                            edist=p_edit)[:rest.size]
            passed[rest[counts2 <= 1]] = True
            sel2 = np.flatnonzero(counts2 >= 2)
            logger.debug("leven filter tier-3: %d rest, %d still ambiguous "
                         "after direction-2 prune", rest.size, sel2.size)
            if sel2.size:
                rest2 = rest[sel2]
                close2 = _close_via_topk(rest2, q_dil, sel2, db_oh)
                complete2 = counts2[sel2] <= k_eff
                passed[rest2] = np.where(complete2, ~close2, passed[rest2])
                passed[rest2[close2]] = False
                over = rest2[~complete2 & ~close2]
                if over.size:
                    logger.debug("leven filter tier-4: %d queries to "
                                 "exact full-DP", over.size)
                    # Tier 4 — exact full-DP k=2 for the residue (both
                    # directions ambiguous, no proven close neighbor);
                    # chunked dispatches, see leven_topk; query-sharded
                    # over the mesh when one is given
                    if mesh is not None:
                        from .sharded import sharded_leven_topk
                        d2, _ = sharded_leven_topk(q_codes[over], db_codes,
                                                   2, mesh=mesh)
                    else:
                        d2, _ = leven_topk(q_codes[over], db_codes, 2)
                    passed[over] = (d2[:, 1] >= 0) & (d2[:, 1] >= e)
    return passed
