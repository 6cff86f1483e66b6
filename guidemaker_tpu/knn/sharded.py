"""Multi-device exact k-NN: database sharding + collective merge.

* the guide *database* shards across the ``d`` mesh axis — each device
  scans only ``n/d`` of it;
* *queries* shard across the ``q`` mesh axis;
* each device runs the single-device engine (:func:`.hamming.count_feats`
  / :func:`.hamming.topk_feats`: the fused GPU kernels on GPUs, the plain
  XLA version elsewhere) on its shard; counts merge with one ``psum``
  over ``d``, top-k keys with one ``all_gather`` over ``d`` and a final
  ``top_k``.  The global N x N distance matrix exists nowhere;
* deterministic by construction: packed (distance, global index) keys
  make the merge independent of the mesh shape, so one-device and
  N-device runs agree bit for bit.

The same code runs on a GPU host and on the virtual CPU mesh used in
tests (``--xla_force_host_platform_device_count``).  Multi-process runs
only need ``jax.distributed.initialize()`` before calling in.
"""
from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .hamming import (DB_TILE, INF_KEY, _pad_rows, bucket_rows, count_feats,
                      fit_tile, keys_to_neighbors, onehot_on_device,
                      pad_code_rows, topk_feats, unpack_keys)


def make_mesh(q_shards: int, d_shards: int,
              devices: Optional[Sequence] = None) -> Mesh:
    """A (q, d) 2-D device mesh: queries x database sharding."""
    if devices is None:
        devices = jax.devices()
    n = q_shards * d_shards
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)}")
    arr = np.array(devices[:n]).reshape(q_shards, d_shards)
    return Mesh(arr, ("q", "d"))


def _smap(mesh, in_specs, out_specs):
    # outputs are replicated over 'd' by the psum / all_gather merge
    return functools.partial(jax.shard_map, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, check_vma=False)


def _put_global(arr_np: np.ndarray, sharding: NamedSharding):
    """Create a (possibly multi-process) global device array.

    Single-process: plain device_put.  Multi-process SPMD (after
    ``init_distributed``): every host holds the full numpy array and
    contributes its addressable shards."""
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(arr_np), sharding)
    return jax.make_array_from_callback(
        arr_np.shape, sharding, lambda idx: arr_np[idx])


@functools.lru_cache(maxsize=64)
def count_step(mesh: Mesh, *, editdist: int, length: int, engine: str):
    """Jitted ``step(q, db) -> (nq,) counts``: partial counts per database
    shard, summed with one ``psum`` over ``d``."""
    def step(q, db):
        local = count_feats(q, db, length=length, editdist=editdist,
                            engine=engine)
        return jax.lax.psum(local, "d")

    return jax.jit(_smap(mesh, (P("q", None), P("d", None)), P("q"))(step))


@functools.lru_cache(maxsize=64)
def topk_step(mesh: Mesh, *, k: int, length: int, engine: str):
    """Jitted ``step(q, db, offsets) -> (nq, k) keys``: per-shard top-k
    with globally offset keys, merged by ``all_gather`` + ``top_k``."""
    def step(q, db, offsets):
        keys = topk_feats(q, db, db.shape[0], k=k, length=length,
                          engine=engine)
        # local -> global index: adding the shard offset to the idx bits
        # cannot carry into the distance bits (global nd < 2^IDX_BITS)
        keys = jnp.where(keys >= INF_KEY, INF_KEY, keys + offsets[0])
        gathered = jax.lax.all_gather(keys, "d", axis=1, tiled=True)
        neg_top, _ = jax.lax.top_k(-gathered, k)
        return -neg_top

    return jax.jit(_smap(mesh, (P("q", None), P("d", None), P("d")),
                         P("q", None))(step))


@dataclass
class ShardedDb:
    """Device-resident int8 database features, sharded over ``d``.

    Built once per index (KnnIndex caches it); queries run against it
    with no further host->device database traffic.  Rows past ``nd`` are
    all-zero padding.
    """
    mesh: Mesh
    feats: jax.Array      # (d_shards * per_shard, F) int8, P('d', None)
    offsets: jax.Array    # (d_shards,) int32 global row offset, P('d')
    nd: int               # true (unpadded) database size
    length: int           # distance is ``length - dot``


def _per_shard(nd: int, d_shards: int) -> int:
    per_dev = max(1, -(-nd // d_shards))
    tile = fit_tile(DB_TILE, per_dev)
    return -(-per_dev // tile) * tile


def _offsets(mesh: Mesh, per_shard: int):
    d_shards = mesh.devices.shape[1]
    return _put_global(np.arange(d_shards, dtype=np.int32) * per_shard,
                       NamedSharding(mesh, P("d")))


def prepare_db_sharded(codes: np.ndarray, mesh: Mesh) -> ShardedDb:
    """Shard + transfer the database once: 2-bit codes cross the host
    link, the int8 one-hot is built on device under the row sharding."""
    nd, length = codes.shape
    per_shard = _per_shard(nd, mesh.devices.shape[1])
    padded = pad_code_rows(codes, per_shard * mesh.devices.shape[1])
    row_sh = NamedSharding(mesh, P("d", None))
    feats = jax.jit(onehot_on_device, out_shardings=row_sh)(
        _put_global(padded, row_sh))
    return ShardedDb(mesh=mesh, feats=feats,
                     offsets=_offsets(mesh, per_shard), nd=nd, length=length)


def shard_features(feats, mesh: Mesh, *, length: int) -> ShardedDb:
    """:class:`ShardedDb` from an (nd, F) feature matrix (host or
    device; a device matrix is resharded on device)."""
    nd = feats.shape[0]
    per_shard = _per_shard(nd, mesh.devices.shape[1])
    rows = per_shard * mesh.devices.shape[1]
    row_sh = NamedSharding(mesh, P("d", None))
    if isinstance(feats, np.ndarray):
        feats = _put_global(_pad_rows(feats.astype(np.int8), rows), row_sh)
    else:
        feats = jax.device_put(
            jnp.pad(feats.astype(jnp.int8), ((0, rows - nd), (0, 0))), row_sh)
    return ShardedDb(mesh=mesh, feats=feats,
                     offsets=_offsets(mesh, per_shard), nd=nd, length=length)


def put_query_codes(q_codes: np.ndarray, mesh: Mesh):
    """Query codes -> one-hot features sharded over ``q`` (rows padded
    with INVALID codes to a bucketed multiple of the q shards)."""
    q_shards = mesh.devices.shape[0]
    per_q = -(-max(1, q_codes.shape[0]) // q_shards)
    padded = pad_code_rows(q_codes, q_shards * bucket_rows(per_q, 8))
    row_sh = NamedSharding(mesh, P("q", None))
    return jax.jit(onehot_on_device, out_shardings=row_sh)(
        _put_global(padded, row_sh))


def put_query_feats(q_feats, mesh: Mesh):
    """Query features (host or device) -> sharded over ``q``, zero rows
    padded to a bucketed multiple of the q shards."""
    q_shards = mesh.devices.shape[0]
    n = q_feats.shape[0]
    rows = q_shards * bucket_rows(-(-max(1, n) // q_shards), 8)
    row_sh = NamedSharding(mesh, P("q", None))
    if isinstance(q_feats, np.ndarray):
        return _put_global(_pad_rows(q_feats.astype(np.int8), rows), row_sh)
    return jax.device_put(
        jnp.pad(q_feats.astype(jnp.int8), ((0, rows - n), (0, 0))), row_sh)


def sharded_count(q_sh, sdb: ShardedDb, editdist: int, *, engine: str):
    """(rows,) device counts of database entries with dist < editdist
    for q-sharded query features ``q_sh`` (padded rows included; callers
    slice).  Requires ``editdist <= sdb.length``."""
    if editdist > sdb.length:
        raise ValueError("editdist must be <= guide length for counting")
    step = count_step(sdb.mesh, editdist=editdist, length=sdb.length,
                      engine=engine)
    return step(q_sh, sdb.feats)


def sharded_topk(q_sh, nq: int, sdb: ShardedDb, k: int, *,
                 engine: str) -> Tuple[np.ndarray, np.ndarray]:
    """Exact k-NN of the first ``nq`` rows of ``q_sh``; contract matches
    :func:`.hamming.hamming_topk` (ascending (dist, idx), -1 padding)."""
    k_eff = min(k, sdb.nd)
    step = topk_step(sdb.mesh, k=k_eff, length=sdb.length, engine=engine)
    keys = step(q_sh, sdb.feats, sdb.offsets)
    return keys_to_neighbors(np.asarray(keys)[:nq], sdb.nd, k)


def sharded_hamming_count(q_feats, db_feats, editdist: int, length: int, *,
                          mesh: Optional[Mesh] = None,
                          engine: str = "xla") -> np.ndarray:
    """(nq,) int32 counts of database entries with ``length - dot <
    editdist``, from (host or device) feature matrices."""
    if mesh is None:
        mesh = make_mesh(1, len(jax.devices()))
    sdb = shard_features(db_feats, mesh, length=length)
    counts = sharded_count(put_query_feats(q_feats, mesh), sdb, editdist,
                           engine=engine)
    return np.asarray(counts)[:q_feats.shape[0]]


def sharded_hamming_topk(q_feats, db_feats, k: int, length: int, *,
                         mesh: Optional[Mesh] = None,
                         engine: str = "xla") -> Tuple[np.ndarray, np.ndarray]:
    """Exact Hamming k-NN over a device mesh from (host or device)
    feature matrices; same contract as :func:`.hamming.hamming_topk`."""
    if mesh is None:
        mesh = make_mesh(1, len(jax.devices()))
    sdb = shard_features(db_feats, mesh, length=length)
    return sharded_topk(put_query_feats(q_feats, mesh), q_feats.shape[0],
                        sdb, k, engine=engine)


@functools.lru_cache(maxsize=64)
def _sharded_leven_step(mesh: Mesh, k: int, length: int, q_tile: int,
                        db_tile: int):
    """jitted shard_map step for Levenshtein: per-shard cummin-DP top-k
    (leven._topk_tiles_leven) with globally-offset keys, all_gather merge."""
    from .leven import _topk_tiles_leven

    def step(qc, db_shard, db_valid, offsets):
        local = _topk_tiles_leven(qc, db_shard, db_valid[0], offsets[0],
                                  k=k, length=length, db_tile=db_tile)
        gathered = jax.lax.all_gather(local, "d", axis=1, tiled=True)
        neg_top, _ = jax.lax.top_k(-gathered, k)
        return -neg_top

    return jax.jit(_smap(
        mesh,
        (P("q", None), P("d", None), P("d"), P("d")),
        P("q", None))(step))


def sharded_leven_topk(q_codes: np.ndarray, db_codes: np.ndarray, k: int, *,
                       mesh: Optional[Mesh] = None, db_tile: int = 1024,
                       q_tile: int = 512) -> Tuple[np.ndarray, np.ndarray]:
    """Exact Levenshtein k-NN, database sharded over ``d``, queries over
    ``q``; same contract as leven_topk."""
    if mesh is None:
        mesh = make_mesh(1, len(jax.devices()))
    q_shards, d_shards = mesh.devices.shape
    nq, length = q_codes.shape
    nd = db_codes.shape[0]
    k_eff = min(k, nd)

    per_dev = max(1, -(-nd // d_shards))
    db_tile = min(db_tile, max(128, 1 << (per_dev - 1).bit_length()))
    per_shard = -(-nd // (d_shards * db_tile)) * db_tile
    db_pad = pad_code_rows(db_codes, per_shard * d_shards)
    offsets = np.arange(d_shards, dtype=np.int32) * per_shard
    valid = np.minimum(np.maximum(nd - offsets, 0), per_shard).astype(np.int32)

    q_tile = min(q_tile, max(8, 1 << (max(1, -(-nq // q_shards)) - 1).bit_length()))
    q_pad = pad_code_rows(q_codes, q_shards * q_tile)

    step = _sharded_leven_step(mesh, k_eff, length, q_tile, db_tile)
    q_sh = jax.device_put(jnp.asarray(q_pad),
                          NamedSharding(mesh, P("q", None)))
    db_sh = jax.device_put(jnp.asarray(db_pad),
                           NamedSharding(mesh, P("d", None)))
    valid_sh = jax.device_put(jnp.asarray(valid), NamedSharding(mesh, P("d")))
    off_sh = jax.device_put(jnp.asarray(offsets), NamedSharding(mesh, P("d")))
    keys = np.asarray(step(q_sh, db_sh, valid_sh, off_sh))[:nq]

    dist, idx = unpack_keys(keys)
    if k_eff < k:
        pad = np.full((nq, k - k_eff), -1, dtype=np.int32)
        dist = np.concatenate([dist, pad], axis=1)
        idx = np.concatenate([idx, pad], axis=1)
    return dist, idx


def sharded_banded_pairs(qa: np.ndarray, ca: np.ndarray, *, t: int,
                         length: int, mesh: Mesh) -> np.ndarray:
    """Row-paired banded Levenshtein over the whole mesh.

    Verification pairs are embarrassingly parallel, so rows shard over
    BOTH mesh axes (q x d flattened) — every device runs the same banded
    kernel on its row slice with no collectives at all.  Contract
    matches leven.banded_leven_pairs (exact for true distance <= t,
    t + 1 beyond the band; identical padding rows compare to 0 and are
    sliced off by the caller).
    """
    from .leven import banded_leven_pairs
    n = qa.shape[0]
    ndev = int(mesh.devices.size)
    qa = _pad_rows(np.asarray(qa), ndev)
    ca = _pad_rows(np.asarray(ca), ndev)
    step = jax.jit(_smap(
        mesh, (P(("q", "d"), None), P(("q", "d"), None)), P(("q", "d")))(
            lambda a, b: banded_leven_pairs(a, b, t=t, length=length)))
    sh = NamedSharding(mesh, P(("q", "d"), None))
    out = step(_put_global(qa, sh), _put_global(ca, sh))
    return np.asarray(out)[:n]
