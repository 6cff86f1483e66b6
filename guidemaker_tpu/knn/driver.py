"""Unified exact k-NN index over guide sequences (Hamming or Levenshtein).

This is the owned, deterministic replacement for the reference's NMSLib
index object (core.py:418-523): build once over the deduplicated target set,
query in batches, reuse for control-guide search.  Distances are exact and
tie-broken by database index, so results are reproducible across runs,
devices, and mesh sizes.
"""
from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from .. import dna
from .leven import leven_topk

#: fixed query-chunk rows for top-k dispatches above one chunk: one
#: compiled program serves any query count (and the phase-2 prewarm
#: compiles exactly that program)
_Q_CHUNK = 32768


def _devices():
    """(platform, device count) of the default JAX backend.  Raises when
    no backend can start: a run never silently moves to another device."""
    import jax
    devices = jax.devices()
    return devices[0].platform, len(devices)


def _default_backend() -> str:
    """Kernel backend, from the platform and the device count:
    'sharded' (a mesh over every device) with several devices, 'pallas'
    (the fused kernels of pallas_gpu) on one GPU, 'xla' (plain XLA)
    elsewhere.  'native' (C++ popcount on the host) is chosen only
    explicitly."""
    platform, n = _devices()
    if n > 1:
        return "sharded"
    return "pallas" if platform == "gpu" else "xla"


def _engine(backend: str) -> str:
    """Per-device engine of a device backend (see hamming.count_feats):
    the GPU kernels for 'pallas', and for 'sharded' on GPUs."""
    if backend == "pallas" or (backend == "sharded"
                               and _devices()[0] == "gpu"):
        return "pallas"
    return "xla"


class KnnIndex:
    """An exact nearest-neighbor index over equal-length guide sequences."""

    def __init__(self, seqs, metric: str = "hamming",
                 backend: str = None, num_threads: int = 0):
        if len(seqs) == 0:
            raise ValueError("cannot build an index over zero sequences")
        self.metric = "hamming" if metric == "hamming" else "leven"
        self.backend = backend or _default_backend()
        self.engine = _engine(self.backend)
        self.num_threads = num_threads  # native backend only (0 = all cores)
        if isinstance(seqs, (list, tuple)):
            # string input: eager list, validated per row (original path)
            self._seqs_list: List[str] = list(seqs)
            self._seq_arr = None     # Arrow form built lazily on demand
            self.length = len(self._seqs_list[0])
            for s in self._seqs_list:
                if len(s) != self.length:
                    raise ValueError(
                        "all indexed sequences must share one length")
            codes = dna.encode_batch(self._seqs_list, self.length)
        else:
            # pandas / pyarrow column input: the codes come straight off
            # the Arrow data buffer and the Python string list is only
            # materialized if a caller asks for `.seqs` (the dict-shaped
            # neighbors API) — saves ~2 s of join/encode at 1.16M guides
            self._seqs_list = None
            codes, self._seq_arr = dna.encode_pandas(seqs)
            self.length = codes.shape[1]
        self._n = codes.shape[0]
        self._codes = codes.astype(np.uint8)
        # the native engines pack 2 bits/base, which aliases INVALID=4
        # to 'A'; ambiguous-base guides must take the JAX paths (one-hot
        # zero rows: N matches nothing)
        self._codes_ambiguous = bool(self._codes.max(initial=0) >= 4)
        self._db_dev = None   # device-resident padded database (lazy)
        self._mesh = None     # device mesh (sharded backend, lazy)
        self._seqset = None   # frozenset(self.seqs), built on first use
        self._dedup_ok = None  # Arrow-path dedup validity, built on first use
        # one lock for every lazy device-database init: the pipeline's
        # background control search calls into the index concurrently
        # with the main thread (pipeline.py launches it right after
        # create_index); unlocked, both could build and upload the
        # database
        import threading
        self._lazy_lock = threading.Lock()

    @property
    def seqs(self) -> List[str]:
        """Indexed sequences as a Python list (materialized lazily — the
        pipeline's Arrow path never needs it; the dict-shaped neighbors
        API does)."""
        if self._seqs_list is None:
            self._seqs_list = self._seq_arr.to_pylist()
        return self._seqs_list

    @property
    def seq_array(self):
        """Indexed sequences as a pyarrow StringArray (no Python
        strings; built from the code matrix when the index was
        constructed from a list)."""
        if self._seq_arr is None:
            import pyarrow as pa
            arr = dna.rows_to_str_array(self._codes)
            self._seq_arr = pa.array(arr, from_pandas=True)
        return self._seq_arr

    def _counting_filter_valid(self, seqs) -> bool:
        """True iff the counting retention shortcut is exact for these
        queries: the database must be duplicate-free and every query a
        member (so the self-hit contributes exactly one count).  Non-member
        queries or duplicated database entries fall back to the k=2 path,
        which implements the general semantics."""
        if not isinstance(seqs, (list, tuple)):
            # Arrow path: C++ hash kernels, no Python sets
            import pyarrow as pa
            import pyarrow.compute as pc
            if self._dedup_ok is None:
                self._dedup_ok = bool(
                    len(self.seq_array.unique()) == self._n)
            if not self._dedup_ok:
                return False
            qa = seqs if isinstance(seqs, pa.Array) \
                else pa.array(seqs, from_pandas=True)
            if qa is self._seq_arr or len(qa) == 0:
                return True
            return bool(pc.all(pc.is_in(
                qa, value_set=self.seq_array)).as_py())
        if self._seqset is None:
            self._seqset = frozenset(self.seqs)
        if len(self._seqset) != self._n:
            return False
        if len(seqs) == self._n and list(seqs) == self.seqs:
            return True
        return all(s in self._seqset for s in seqs)

    def _sharded_db(self):
        """Device-resident sharded database (built once, reused by every
        query/filter call — the database never re-crosses the host link)."""
        if self._db_dev is None:
            with self._lazy_lock:
                if self._db_dev is None:
                    from .sharded import prepare_db_sharded
                    self._db_dev = prepare_db_sharded(self._codes,
                                                      self._get_mesh())
        return self._db_dev

    def _get_mesh(self):
        if self._mesh is None:
            from ..distributed import auto_mesh
            self._mesh = auto_mesh()
        return self._mesh

    def _ensure_db(self):
        """Device-resident int8 one-hot database of the single-device
        backends (thread-safe: the pipeline's background control search
        calls into the index concurrently with the main thread)."""
        if self._db_dev is None:
            with self._lazy_lock:
                if self._db_dev is None:
                    from .hamming import prepare_db
                    self._db_dev = prepare_db(self._codes)
        return self._db_dev

    def __len__(self) -> int:
        return self._n

    def _encode_queries(self, seqs) -> np.ndarray:
        if isinstance(seqs, (list, tuple)):
            return dna.encode_batch(seqs, self.length)
        codes, _ = dna.encode_pandas(seqs, self.length)
        return codes

    def _seqs_equal_db(self, seqs) -> bool:
        """Query batch == the whole database, in order (enables the
        all-vs-all shortcuts that reuse the resident device database)."""
        if isinstance(seqs, (list, tuple)):
            return list(seqs) == self.seqs
        if seqs is self._seq_arr:
            return True
        import pyarrow as pa
        import pyarrow.compute as pc
        qa = seqs if isinstance(seqs, pa.Array) \
            else pa.array(seqs, from_pandas=True)
        return bool(pc.all(pc.equal(qa, self.seq_array)).as_py())

    def query(self, seqs: Sequence[str], k: int) -> Tuple[np.ndarray, np.ndarray]:
        """k nearest database entries for each query sequence.

        Returns (dists, idx), each (nq, k) int32, ascending by
        (distance, database index); -1 padding when k > len(db).
        Distances are in *bases* (the reference's one-hot bit-Hamming
        doubling, core.py:510-514, is already divided out).
        """
        if len(seqs) == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.int32))
        return self.query_codes(self._encode_queries(seqs), k)

    def query_codes(self, qc: np.ndarray,
                    k: int) -> Tuple[np.ndarray, np.ndarray]:
        """query() on pre-encoded (nq, L) uint8 codes — skips the string
        round-trip (the control-guide search samples codes directly)."""
        if qc.shape[0] == 0:
            return (np.empty((0, k), np.int32), np.empty((0, k), np.int32))
        qc = np.asarray(qc, dtype=np.uint8)
        if self.metric != "hamming":
            if (self.backend == "native" and self.length <= 32
                    and not self._codes_ambiguous
                    and not (qc >= 4).any()):
                from .. import native
                if native.available():
                    return native.leven_topk(qc, self._codes, k,
                                             n_threads=self.num_threads)
            if self.backend == "sharded":
                from .sharded import sharded_leven_topk
                return sharded_leven_topk(qc, self._codes, k,
                                          mesh=self._get_mesh())
            if getattr(self, "_leven_db", None) is None:
                with self._lazy_lock:
                    if getattr(self, "_leven_db", None) is None:
                        import jax.numpy as jnp
                        from .hamming import _pad_rows
                        nd = self._n
                        tile = min(4096, max(
                            128, 1 << int(nd - 1).bit_length()))
                        self._leven_tile = tile
                        self._leven_db = jnp.asarray(
                            _pad_rows(self._codes, tile))
            return leven_topk(qc, self._codes, k, db_tile=self._leven_tile,
                              db_dev=self._leven_db)
        return self.hamming_query_codes(qc, k)

    def hamming_query_codes(self, qc: np.ndarray,
                            k: int) -> Tuple[np.ndarray, np.ndarray]:
        """Exact HAMMING k-NN on pre-encoded codes, regardless of the
        index metric — the 2-bit code database is metric-agnostic, so a
        Levenshtein index answers Hamming queries for free.  Used by the
        control-guide search, whose distance rule is Hamming by
        definition (config key ``MINIMUM_HMDIST``; the controls table's
        reported column is literally "Hamming distance")."""
        qc = np.asarray(qc, dtype=np.uint8)
        if (self.backend == "native" and not self._codes_ambiguous
                and not (qc >= 4).any()):
            from .. import native
            if native.available():
                return native.hamming_topk(qc, self._codes, k,
                                           n_threads=self.num_threads)
        import jax
        import jax.numpy as jnp
        from .hamming import (bucket_rows, keys_to_neighbors,
                              onehot_on_device, pad_code_rows, topk_feats)
        nd, nq = self._n, qc.shape[0]
        k_eff = min(k, nd)
        if self.backend == "sharded":
            from .sharded import put_query_codes, sharded_topk
            sdb = self._sharded_db()
            return sharded_topk(put_query_codes(qc, sdb.mesh), nq, sdb, k,
                                engine=self.engine)
        db = self._ensure_db()
        # above one chunk, every dispatch has the fixed chunk shape (tail
        # padded with INVALID rows); below, a pow2 bucket
        rows = _Q_CHUNK if nq > _Q_CHUNK else bucket_rows(nq, 256)
        keys = []
        for lo in range(0, nq, rows):
            part = pad_code_rows(qc[lo:lo + rows], rows)
            keys.append(topk_feats(onehot_on_device(jnp.asarray(part)), db,
                                   nd, k=k_eff, length=self.length,
                                   engine=self.engine))
        out = np.concatenate(jax.device_get(keys))[:nq]
        return keys_to_neighbors(out, nd, k)

    def pass_distance_filter(self, seqs: Sequence[str],
                             editdist: int) -> np.ndarray:
        """(nq,) bool: does each query's 2nd-nearest neighbor (self is the
        1st — queries must be members of this index) sit at distance
        >= editdist?  This is the reference's guide-retention rule
        (core.py:509-522) without materializing any neighbor lists.

        On the device backends this is a counting pass — one compare per
        guide pair and a (nq,) count transfer; the native backend and
        queries that break the counting preconditions derive it from a
        k=2 query.
        """
        if len(seqs) == 0:
            return np.zeros(0, dtype=bool)
        nd = self._n
        if nd < 2:
            # reference semantics: dists[1] is padding (-1) -> nothing passes
            return np.zeros(len(seqs), dtype=bool)
        counting_ok = (self.backend != "native"
                       and editdist <= self.length
                       and self._counting_filter_valid(seqs))
        if self.metric == "leven" and counting_ok:
            # tensor-core counting + banded-DP verification (see
            # leven.leven_pass_filter); exact, and orders of magnitude
            # cheaper than the full-DP k=2 query at genome scale.  On the
            # sharded backend every tier runs over the mesh.
            from .leven import leven_pass_filter
            mesh = self._get_mesh() if self.backend == "sharded" else None
            return leven_pass_filter(self._encode_queries(seqs),
                                     self._codes, editdist,
                                     engine=self.engine, mesh=mesh)
        if self.metric == "hamming" and counting_ok:
            if (self.backend != "sharded" and len(seqs) == nd
                    and self._seqs_equal_db(seqs)):
                # all-vs-all: the resident database is the query matrix
                from .hamming import count_feats
                db = self._ensure_db()
                counts = np.asarray(count_feats(
                    db, db, length=self.length, editdist=editdist,
                    engine=self.engine))[:nd]
            else:
                counts = self.count_within(self._encode_queries(seqs),
                                           editdist)
            # dists[1] >= editdist  <=>  count(dist < editdist) <= 1: for
            # editdist > 0 the self-hit always contributes exactly 1; for
            # editdist == 0 nothing does and every query passes (matching
            # the reference threshold, which is vacuous at 0)
            return counts <= 1
        dists, _ = self.query(seqs, k=2)
        return (dists[:, 1] >= 0) & (dists[:, 1] >= editdist)

    def _count_device(self, codes, editdist: int):
        """(nq,) int32 DEVICE counts of database entries at Hamming
        distance < ``editdist`` for host or device codes."""
        import jax.numpy as jnp
        from .hamming import bucket_rows, count_feats, onehot_on_device
        nq = int(codes.shape[0])
        dev = jnp.asarray(codes)
        if self.backend == "sharded":
            from .sharded import put_query_codes, sharded_count
            sdb = self._sharded_db()
            return sharded_count(put_query_codes(np.asarray(codes), sdb.mesh),
                                 sdb, editdist, engine=self.engine)[:nq]
        pad = bucket_rows(nq, 256) - nq
        if pad:   # pad rows on device with INVALID=4 (one-hots to zero)
            dev = jnp.pad(dev, ((0, pad), (0, 0)), constant_values=4)
        return count_feats(onehot_on_device(dev), self._ensure_db(),
                           length=self.length, editdist=editdist,
                           engine=self.engine)[:nq]

    def count_within(self, codes, editdist: int):
        """(nq,) int32 raw counts of database entries at HAMMING distance
        < ``editdist`` per query, or None when unsupported (native
        backend) — callers fall back to an exact k=1/k=2 query.

        Unlike :meth:`pass_distance_filter`, no membership precondition:
        these are plain counts (``count == 0`` <=> hamming nearest >=
        editdist).  The counter is meaningful on a Levenshtein index too:
        leven <= hamming always, so ``count > 0`` soundly implies a
        Levenshtein neighbor closer than ``editdist`` (callers must still
        verify the survivors exactly).  ``codes`` may be a host array or
        a device-resident one.
        """
        if not self.supports_chunk_triage(editdist):
            return None
        return np.asarray(self._count_device(codes, editdist))

    def supports_chunk_triage(self, editdist: int) -> bool:
        """True iff the counting triage (:meth:`count_within`,
        :meth:`pass_mask_chunks`) runs on this backend — lets the control
        ladder pick its path ONCE."""
        return self.backend != "native" and editdist <= self.length

    def pass_mask_chunks(self, chunks, editdist: int):
        """(rows,) uint8 host mask over a list of EQUAL-SHAPE device
        candidate chunks — 1 iff NO database entry lies at Hamming
        distance < ``editdist`` (the control ladder's triage decision) —
        or None when unsupported.

        Every chunk reuses ONE fixed-shape counting executable; the masks
        concatenate on device and move to the host in one transfer.
        """
        if not self.supports_chunk_triage(editdist):
            return None
        import jax.numpy as jnp
        masks = [(self._count_device(dev, editdist) == 0).astype(jnp.uint8)
                 for dev in chunks]
        return np.asarray(masks[0] if len(masks) == 1
                          else jnp.concatenate(masks))

    def neighbor_seqs(self, idx_row: np.ndarray) -> List[str]:
        """Map database indices to sequences (fixes the reference's
        set-ordering index bug, core.py:446 vs core.py:513)."""
        return [self.seqs[int(i)] for i in idx_row if int(i) >= 0]

    # ------------------------------------------------------------------
    # persistence (the reference never saves its NMSLib index; exact
    # indexes round-trip trivially as the packed code matrix)
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        """Save the index to an .npz file (codes + metric + backend)."""
        np.savez_compressed(path, codes=self._codes,
                            metric=np.str_(self.metric),
                            backend=np.str_(self.backend))

    @classmethod
    def load(cls, path: str, backend: str = None) -> "KnnIndex":
        z = np.load(path)
        codes = z["codes"]
        seqs = dna.decode_rows(codes)
        return cls(seqs, metric=str(z["metric"]),
                   backend=backend or str(z["backend"]))


def knn_search(db_seqs: Sequence[str], q_seqs: Sequence[str], k: int,
               metric: str = "hamming") -> Tuple[np.ndarray, np.ndarray]:
    """One-shot exact k-NN: build + query."""
    return KnnIndex(db_seqs, metric).query(q_seqs, k)
