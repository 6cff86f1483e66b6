"""Guide pool processing: filters, exact off-target k-NN, control guides.

Equivalent of the reference's ``TargetProcessor`` (``core.py:295-633``)
with the same public methods and semantics, but the NMSLib HNSW index
replaced by the exact matrix-product k-NN engine in
:mod:`guidemaker_tpu.knn`.

Deliberate fixes vs the reference (documented, all strictly stronger):

* the index is built over the *first-occurrence-ordered* deduplicated
  target list instead of hash-ordered ``list(set(...))`` (core.py:446) —
  results are deterministic;
* reported "Similar guides" strings are looked up in the index's own
  ordering (the reference indexed the full targets column with dedup-set
  indices — core.py:513 — making those strings unreliable);
* control search succeeding on the last escalation rung returns instead of
  raising ``IndexError`` (reference loop condition quirk, core.py:586).
"""
from __future__ import annotations

import hashlib
import logging
import re
import statistics
import time
from copy import deepcopy
from typing import Dict, List, Optional

import numpy as np
import pandas as pd
import yaml

from . import dna
from .io.records import record_id_and_seq
from .knn import KnnIndex

logger = logging.getLogger(__name__)

pd.options.mode.chained_assignment = None

_SAMPLER = None


def _device_sampler():
    """Lazily-built jitted control-candidate sampler (module-level so the
    jit cache persists across calls; rebuilding it per call would retrace)."""
    global _SAMPLER
    if _SAMPLER is None:
        import functools
        import jax
        import jax.numpy as jnp

        @functools.partial(jax.jit, static_argnames=("m", "length"))
        def sample(key, cum, *, m, length):
            # inverse-CDF over the reference's G,C,A,T order; uint8 codes
            bases = jnp.asarray([2, 1, 0, 3], dtype=jnp.uint8)
            u = jax.random.uniform(key, (m, length), dtype=jnp.float32)
            cell = jnp.sum(u[..., None] >= cum, axis=-1).astype(jnp.uint8)
            return jnp.take(bases, jnp.minimum(cell, 3))

        _SAMPLER = sample
    return _SAMPLER


#: chunks triaged per device round in the control search — the
#: early-exit granularity: a group of 2 keeps the dispatch pipeline full
#: while letting the search stop soon after the pool covers n
_TRIAGE_GROUP = 2

#: max passers gathered per triage chunk through the fixed-shape take
#: (pass rates on a successful rung sit near n/m ~ 1e-4, so a chunk
#: carries a handful of passers; a chunk exceeding the cap falls back
#: to the rung-wide gather)
_PASSER_CAP = 1024


def _control_chunk_rows(n: int, multiples) -> int:
    """Fixed candidate-chunk row count for the control-ladder triage:
    the first rung's size as a power of two, within [2^13, 2^19].

    Chosen from the request alone, so a seeded run draws the same
    controls on every platform: the value is a shape constant, and
    changing it changes which threefry streams the rungs draw.
    """
    first = max(1, n * int(multiples[0]))
    return min(1 << 19, max(1 << 13, 1 << (first - 1).bit_length()))


class TargetProcessor:
    """A set of candidate gRNA targets plus processing state."""

    def __init__(self, targets: pd.DataFrame, lsr: int, editdist: int = 2,
                 knum: int = 2) -> None:
        self.targets = targets
        self.lsr: int = lsr
        self.editdist: int = editdist
        self.knum: int = knum
        self.index: Optional[KnnIndex] = None
        self._nb_pass_seqs: List[str] = []
        self._nb_dists: Optional[np.ndarray] = None  # (npass, k) int32
        self._nb_idxs: Optional[np.ndarray] = None   # (npass, k) int32
        self._neighbors_cache: Optional[Dict] = None
        self.ncontrolsearched: Optional[int] = None
        self.gc_percent: Optional[float] = None
        self.genomesize: Optional[float] = None
        self.pam_orientation: bool = bool(targets["pam_orientation"].iat[0])

    # `nmslib_index` name kept for API compatibility with the reference.
    @property
    def nmslib_index(self):
        return self.index

    def __str__(self) -> str:
        return "TargetList: contains a set of {} potential PAM targets".format(
            len(self.targets))

    def __len__(self) -> int:
        return len(self.targets)

    # ------------------------------------------------------------------
    def check_restriction_enzymes(self, restriction_enzyme_list: list = None) -> None:
        """Flag guides containing a restriction site or its reverse complement.

        Matches reference behavior (core.py:354-377): rows are *flagged*,
        never dropped; the flag feeds the neighbor-query filter.
        """
        if restriction_enzyme_list is None:
            restriction_enzyme_list = []
        element_to_exclude: List[str] = []
        for record in set(restriction_enzyme_list):
            for letter in record.upper():
                assert letter in set("ACGTMRWSYKVHDBXN")
            element_to_exclude.extend(dna.extend_ambiguous_dna(record.upper()))
            element_to_exclude.extend(
                dna.extend_ambiguous_dna(dna.reverse_complement(record.upper())))
        if element_to_exclude:
            pattern = re.compile("|".join(element_to_exclude))
            self.targets["hasrestrictionsite"] = self.targets["target"].apply(
                lambda s: bool(pattern.search(s)))
        else:
            self.targets["hasrestrictionsite"] = False

    # ------------------------------------------------------------------
    def find_unique_near_pam(self) -> None:
        """Mark targets whose PAM-proximal seed region is duplicated.

        Seed = first ``lsr`` bases for 5prime PAMs, last ``lsr`` for 3prime;
        ``lsr == 0`` means the whole guide (core.py:388-416).  First
        occurrence is kept (pandas ``duplicated`` default).
        """
        lsr = self.lsr

        # vectorized seed slice (Arrow utf8 kernels): 5prime PAM -> prefix,
        # 3prime -> suffix, lsr == 0 -> whole guide (core.py:402-412)
        self.targets = self.targets.copy()
        tcol = self.targets["target"]
        if lsr == 0:
            seed = tcol.copy()
        elif self.pam_orientation:            # 5prime
            seed = tcol.str.slice(0, lsr)
        else:                                 # 3prime
            seed = tcol.str.slice(-lsr)
        self.targets.loc[:, "seedseq"] = seed
        self.targets.loc[:, "isseedduplicated"] = seed.duplicated()

    # ------------------------------------------------------------------
    def create_index(self, configpath: str = None, num_threads: int = 2) -> None:
        """Build the exact k-NN index over the deduplicated target set.

        ``configpath``/``num_threads`` are accepted for reference CLI/API
        compatibility; the exact engine has no recall hyperparameters
        (NMSLIB M/efC/ef/post become no-ops — exactness replaces tuning).
        """
        if configpath is not None:
            with open(configpath) as cf:
                yaml.safe_load(cf)  # validated for parity; no knobs needed
        # Arrow-native dedup + encode: pd.unique keeps first-occurrence
        # order (the determinism fix vs the reference's set()) and the
        # index encodes straight off the Arrow buffer — no Python string
        # list is ever built (was ~2 s of the index-build stage at 1.16M)
        notduplicated_targets = pd.unique(self.targets["target"])
        metric = str(self.targets["dtype"].iat[0])
        metric = "hamming" if metric == "hamming" else "leven"
        logger.info("Building exact %s k-NN index over %d unique targets",
                    metric, len(notduplicated_targets))
        self.index = KnnIndex(notduplicated_targets, metric=metric,
                              num_threads=num_threads)

    # ------------------------------------------------------------------
    def get_neighbors(self, configpath: str = None, num_threads: int = 2) -> None:
        """Exact k-NN for all seed-unique-or-restriction-free targets.

        Keeps a query iff its second-nearest neighbor (hit 0 is self) is at
        least ``editdist`` away — the reference's thresholding at
        core.py:509-522, with the one-hot x2 factor already divided out.
        The reference's ``|`` (OR) query filter at core.py:495 is
        replicated verbatim.
        """
        mask = ((self.targets["isseedduplicated"] == False)  # noqa: E712
                | (self.targets["hasrestrictionsite"] == False))  # noqa: E712
        # Arrow-native query prep: drop_duplicates keeps first occurrence
        # (same semantics as the old dict.fromkeys over a Python list,
        # without materializing 1.16M strings)
        query_seqs = self.targets.loc[mask, "target"].drop_duplicates()
        # phase-2 prewarm runs CONCURRENTLY with the retention counting
        # compile below (XLA compiles release the GIL): on a cold cache
        # the two compiles overlap instead of serializing inside this
        # (already-backgrounded) thread
        warm_t = self._launch_phase2_prewarm()
        # Phase 1 — retention decision only (a counting pass on the
        # device backends: one compare per pair instead of a top-k
        # merge).  The k-NN lists themselves are computed lazily, and
        # only for the guides that still need them after annotation
        # filtering (usually ~10% of the pool).
        pass_mask = self.index.pass_distance_filter(query_seqs,
                                                    self.editdist)
        self._neighbors_cache = None
        # only the ~10% passers are materialized as Python strings
        self._nb_pass_seqs = query_seqs[np.asarray(pass_mask)].tolist()
        self._nb_dists = None   # lazy; see _neighbor_arrays()
        self._nb_idxs = None
        logger.info("%d of %d queried targets passed the distance filter",
                    len(self._nb_pass_seqs), len(query_seqs))
        if warm_t is not None:
            warm_t.join()

    def _launch_phase2_prewarm(self):
        """Compile + load the phase-2 neighbor-list executable in a
        daemon thread.

        Large query sets always dispatch in fixed-size chunks (8192
        rows for leven_topk, 32768 for the hamming top-k — both pad the
        tail), so ONE dummy chunk compiles + loads the exact executable
        neighbor_frame will use and leaves the device database resident
        — its first-use cost overlaps the retention counting instead of
        sitting inside the format stage.
        """
        if (self.index.backend in ("native",)
                or len(self.index) <= 8192):
            return None
        import threading

        def _warm():
            try:
                rows = 8192 if self.index.metric == "leven" else 32768
                self.index.query_codes(
                    np.zeros((rows, self.index.length), np.uint8),
                    k=self.knum)
            except Exception:   # best-effort only
                logger.debug("phase-2 prewarm failed", exc_info=True)

        t = threading.Thread(target=_warm, name="gm-phase2-prewarm",
                             daemon=True)
        t.start()
        return t

    def _neighbor_arrays(self):
        """k-NN (dists, idxs) for all passing queries, computed on first
        use (the raw-guides path never needs them at all)."""
        if self._nb_dists is None:
            if self._nb_pass_seqs:
                self._nb_dists, self._nb_idxs = self.index.query(
                    self._nb_pass_seqs, k=self.knum)
            else:
                self._nb_dists = np.empty((0, self.knum), np.int32)
                self._nb_idxs = np.empty((0, self.knum), np.int32)
        return self._nb_dists, self._nb_idxs

    # ------------------------------------------------------------------
    @property
    def neighbors(self) -> Dict:
        """Reference-shaped neighbor dict
        ``{queryseq: {target, neighbors: {seqs, dist}}}`` (core.py:504-523).

        Materialized lazily from the array results: building >1M nested
        dicts costs ~30 s in CPython, and the pipeline itself never needs
        the dict form (it uses :meth:`neighbor_frame` /
        :meth:`passing_seqs`).  Library users keep the reference API.
        """
        if self._neighbors_cache is None:
            import gc
            neighbor_dict: Dict = {}
            if len(self._nb_pass_seqs):
                nb_dists, nb_idxs = self._neighbor_arrays()
                dlist = nb_dists.tolist()
                ilist = nb_idxs.tolist()
                db_seqs = self.index.seqs
                padded = bool((nb_dists < 0).any())
                gc.disable()  # ~1.4x: no cyclic garbage is created here
                try:
                    for qi, queryseq in enumerate(self._nb_pass_seqs):
                        drow = dlist[qi]
                        if padded:
                            drow = [d for d in drow if d >= 0]
                        neighbor_dict[queryseq] = {
                            "target": queryseq,
                            "neighbors": {
                                "seqs": [db_seqs[j]
                                         for j in ilist[qi][:len(drow)]],
                                "dist": drow,
                            },
                        }
                finally:
                    gc.enable()
            self._neighbors_cache = neighbor_dict
        return self._neighbors_cache

    @neighbors.setter
    def neighbors(self, value: Dict) -> None:
        self._neighbors_cache = value
        self._nb_pass_seqs = list(value.keys())
        # drop materialized arrays: they are indexed by the old key order
        # and would otherwise serve stale rows from neighbor_frame
        self._nb_dists = None
        self._nb_idxs = None

    def passing_seqs(self) -> List[str]:
        """Query sequences that passed the distance filter (dict keys)."""
        return self._nb_pass_seqs

    def neighbor_frame(self, seqs) -> pd.DataFrame:
        """Vectorized ``Similar guides`` / ``Similar guide distances``
        columns for the given guide sequences (must be passing seqs).

        Equivalent to joining ``neighbors[seq]['neighbors']`` with ';'
        (core.py:929-931) but only materializes strings for the guides
        that survive annotation filtering.
        """
        from .util import substage_timer
        seqs = list(seqs)
        if self._nb_dists is not None:
            pos = pd.Index(self._nb_pass_seqs).get_indexer(seqs)
            if (pos < 0).any():
                missing = [s for s, p in zip(seqs, pos) if p < 0][:3]
                raise KeyError(f"sequences not in neighbor results: {missing}")
            d = self._nb_dists[pos]
            i = self._nb_idxs[pos]
        else:
            # lazy phase 2: k-NN lists only for the guides actually kept
            with substage_timer("nbframe: phase-2 query n=%d" % len(seqs)):
                d, i = self.index.query(seqs, k=self.knum)
        # vectorized ';' assembly: Arrow's elementwise join with
        # null_handling='skip' reproduces the truncate-at-first-invalid
        # semantics (invalid (-1) entries are a suffix: distances sort
        # ascending and -1 only pads k > db rows) ~10x faster than the
        # 100k-row python loop
        import pyarrow as pa
        import pyarrow.compute as pc
        with substage_timer("nbframe: arrow assembly"):
            valid = d >= 0
            db_arr = self.index.seq_array   # Arrow, no Python strings
            if pa.types.is_large_string(db_arr.type):
                # the ';' literal below binds as `string`; the elementwise
                # join kernel wants uniform types
                db_arr = db_arr.cast(pa.string())
            seq_cols, dist_cols = [], []
            for c in range(d.shape[1]):
                v = pa.array(valid[:, c])
                idx = pc.if_else(v, pa.array(i[:, c].astype(np.int32)),
                                 pa.scalar(None, pa.int32()))
                seq_cols.append(pc.take(db_arr, idx))
                dist_cols.append(pc.if_else(
                    v, pc.cast(pa.array(d[:, c].astype(np.int32)), pa.string()),
                    pa.scalar(None, pa.string())))
            # column 0 must never be null: the Arrow join DROPS (not
            # empties) all-null rows, which would misalign the frame.  A
            # row can only be all-invalid if d[:, 0] < 0, impossible for
            # member queries (self-hit) — fill_null('') makes the length
            # invariant unconditional anyway.
            seq_cols[0] = pc.fill_null(seq_cols[0], "")
            dist_cols[0] = pc.fill_null(dist_cols[0], "")
            seq_strs = pc.binary_join_element_wise(
                *seq_cols, ";", null_handling="skip")
            dist_strs = pc.binary_join_element_wise(
                *dist_cols, ";", null_handling="skip")
        return pd.DataFrame({
            "Guide sequence": list(seqs),
            "Similar guides": seq_strs.to_pylist(),
            "Similar guide distances": dist_strs.to_pylist(),
        })

    # ------------------------------------------------------------------
    def export_bed(self) -> pd.DataFrame:
        """Seed-unique targets as a sorted 5-column BED-like frame
        (core.py:525-543)."""
        df = self.targets.loc[self.targets["isseedduplicated"] == False].copy()  # noqa: E712
        df = df[["seqid", "start", "stop", "target", "strand"]]
        df = df.assign(strand=np.where(df["strand"], "+", "-"))
        df.columns = ["chrom", "chromstart", "chromend", "name", "strand"]
        df = df.astype({"chrom": "str"})
        df.sort_values(by=["chrom", "chromstart"], inplace=True)
        return df

    # ------------------------------------------------------------------
    def prewarm_controls(self, configpath: str, length: int, n: int):
        """Start compiling the control-search device programs in a daemon
        thread so their first-use cost overlaps the host-bound
        annotation/scoring stages.

        Compiles exactly the shapes ``get_control_seqs`` will use: the
        fixed-chunk on-device sampler, the fixed-chunk counting triage
        (ONE executable serves every rung — see ``_control_chunk_rows``),
        and the exact k=1 query at the passer-batch buckets.
        Returns the thread; join it (or just call ``get_control_seqs``,
        which tolerates overlap) at any point.
        """
        import threading

        def _warm_triage():
            try:
                import jax
                import jax.numpy as jnp
                with open(configpath) as cf:
                    ctl = yaml.safe_load(cf)["CONTROL"]
                mindist_ = ctl["MINIMUM_HMDIST"]
                chunk = _control_chunk_rows(
                    n, ctl["CONTROL_SEARCH_MULTIPLE"])
                cum = jnp.cumsum(jnp.asarray([.25, .25, .25, .25],
                                             jnp.float32))
                codes_dev = _device_sampler()(jax.random.PRNGKey(0), cum,
                                              m=chunk, length=length)
                pm = self.index.pass_mask_chunks([codes_dev], mindist_)
                if pm is not None:
                    # warm the fixed-shape passer gather (take + fetch)
                    self._gather_chunk_passers(
                        [codes_dev], np.arange(2, dtype=np.int64))
                else:
                    self.index.count_within(codes_dev, mindist_)
            except Exception:   # prewarm is best-effort only
                logger.debug("control triage prewarm failed", exc_info=True)

        def _warm_verify():
            try:
                # verify batches are pow2-bucketed: warm the first
                # gather's bucket plus the one an n-request's accumulated
                # pool typically lands in
                near_n = max(_PASSER_CAP,
                             1 << (int(max(2 * n, 1) - 1).bit_length()))
                for rows in sorted({_PASSER_CAP, near_n}):
                    self.index.hamming_query_codes(
                        np.zeros((rows, length), np.uint8), k=1)
            except Exception:
                logger.debug("control verify prewarm failed", exc_info=True)

        # two threads: on a cold cache the triage-counting and exact-k=1
        # compiles are each multi-second; in one thread they would run
        # one after the other
        ts = [threading.Thread(target=f, name=nm, daemon=True)
              for f, nm in ((_warm_triage, "gm-controls-prewarm"),
                            (_warm_verify, "gm-controls-prewarm-verify"))]
        for t in ts:
            t.start()
        self._prewarm_thread = ts[0]
        self._prewarm_thread2 = ts[1]
        return ts[0]

    # ------------------------------------------------------------------
    @staticmethod
    def _gather_chunk_passers(chunks, passers):
        """Fetch passer candidate codes from equal-shape device chunks.

        Per-chunk gathers with indices padded to ``_PASSER_CAP`` keep the
        gather a single fixed-shape executable (prewarmable; an
        unbucketed ``take`` over the whole rung would recompile on every
        run because passer counts vary).  Everything then moves
        host-side in ONE batched transfer.
        Returns the (npass, L) uint8 host matrix in ``passers`` order, or
        None when any chunk holds more than ``_PASSER_CAP`` passers (the
        caller falls back to the rung-wide gather).
        """
        import jax
        import jax.numpy as jnp

        chunk = int(chunks[0].shape[0])
        local = []
        for c in range(len(chunks)):
            li = passers[(passers >= c * chunk)
                         & (passers < (c + 1) * chunk)] - c * chunk
            if li.size > _PASSER_CAP:
                return None
            local.append(li)
        takes, sizes = [], []
        for c, li in enumerate(local):
            if li.size == 0:
                continue
            idx = np.zeros(_PASSER_CAP, np.int32)
            idx[:li.size] = li
            takes.append(jnp.take(chunks[c], jnp.asarray(idx), axis=0))
            sizes.append(int(li.size))
        fetched = jax.device_get(takes)
        return np.concatenate([f[:s] for f, s in zip(fetched, sizes)])

    def _control_search(self, gc: float, length: int, n: int,
                        multiples, minimum_hmdist_target: int,
                        seed: Optional[int]):
        """The escalation-ladder search (core.py:586-623), on the device:

        * candidate codes are sampled ON DEVICE (threefry PRNG) — a 10M-
          candidate rung moves zero candidate bytes over the host link;
        * each rung is triaged by the counting pass: a candidate passes
          iff count(dist < MINIMUM_HMDIST) == 0 <=> nearest >= target, one
          compare per pair and a 1-byte-per-candidate result transfer;
        * verified passers ACCUMULATE across chunks and rungs (round-5
          divergence, documented in PARITY.md: the reference re-samples
          every rung from scratch and ranks one rung's pool; here a rung
          that found 600/1000 keepers contributes them instead of being
          discarded, and the search stops at the first chunk where the
          accumulated count reaches ``n`` — the escalation schedule
          survives only as the sampling budget ``n * multiples[-1]``);
        * exact nearest distances are computed only for the passers, and
          selection is still "the n most distant verified candidates";
        * on a Levenshtein index the counting triage is sound but
          optimistic (leven <= hamming), so passers are verified with
          exact k=1 distances and the failures dropped before counting
          toward ``n``;
        * the native engine (no counting pass) verifies every candidate
          of a rung with exact k=1, with the same accumulation semantics.
        """
        import jax
        import jax.numpy as jnp

        if seed is None:
            seed = int(np.random.default_rng().integers(0, 2 ** 63))
        key = jax.random.PRNGKey(seed)
        # reference base order G, C, A, T (core.py:590-592)
        cum = jnp.cumsum(jnp.asarray(
            [gc / 2, gc / 2, (1 - gc) / 2, (1 - gc) / 2], jnp.float32))

        sample_codes = _device_sampler()
        # candidates are sampled in FIXED-SHAPE chunks so every triage
        # group (and the prewarm) reuses one sampler executable and one
        # counting executable instead of one per rung size.  Chunking
        # also bounds head-of-line blocking of the concurrent
        # annotation/scoring stages' device work, and it is the early-exit
        # granularity: chunks are triaged in groups of ``_TRIAGE_GROUP``
        # and the search returns as soon as the verified-passer pool
        # covers n.
        chunk = _control_chunk_rows(n, multiples)

        acc: List[np.ndarray] = []    # verified passer codes so far
        acc_dist: List[np.ndarray] = []   # their exact nearest distances
        acc_n = 0
        searched = 0

        def verify(pc):
            """Exact HAMMING k=1 distances; keep only >= target passers.

            The control rule is Hamming by definition — the config key
            is ``MINIMUM_HMDIST`` and the reported column is "Hamming
            distance" — so a Levenshtein run screens its controls by the
            same rule (the reference quirk of ranking by its leven
            index's distances makes genome-scale leven runs exhaust the
            ladder: measured <1000 leven>=7 candidates in 11.1M draws on
            P. aeruginosa; documented divergence, PARITY.md)."""
            nonlocal acc_n
            dists, _ = self.index.hamming_query_codes(pc, k=1)
            nearest = dists[:, 0].astype(np.int64)
            keep = nearest >= minimum_hmdist_target
            if keep.any():
                acc.append(pc[keep])
                acc_dist.append(nearest[keep])
                acc_n += int(keep.sum())

        def result(search_mult):
            pc_all = np.concatenate(acc)
            nearest = np.concatenate(acc_dist)
            order = np.argsort(-nearest, kind="stable")[:n]
            sort_dist = [float(nearest[i]) for i in order]
            sort_seq = dna.decode_rows(pc_all[order])
            return sort_seq, sort_dist, search_mult, searched

        # pick the triage path ONCE (the support condition is rung-
        # invariant)
        chunked_ok = self.index.supports_chunk_triage(minimum_hmdist_target)
        search_mult = 0
        for rung, search_mult in enumerate(multiples):
            t_rung = time.time()
            m = n * search_mult
            rkey = jax.random.fold_in(key, rung)
            nchunks = -(-m // chunk)
            c0 = 0
            while chunked_ok and c0 < nchunks:
                grp = list(range(c0, min(c0 + _TRIAGE_GROUP, nchunks)))
                chunks = [sample_codes(jax.random.fold_in(rkey, c), cum,
                                       m=chunk, length=length)
                          for c in grp]
                # triage transfer: one uint8/candidate in a single fetch;
                # chunk dispatches are async, so the host waits once per
                # group, not once per chunk
                pm = self.index.pass_mask_chunks(chunks,
                                                 minimum_hmdist_target)
                if pm is None:      # defensive: gate said yes, kernel said no
                    chunked_ok = False
                    break
                valid = min(len(grp) * chunk, m - c0 * chunk)
                passers = np.flatnonzero(pm[:valid])
                searched += valid
                c0 += len(grp)
                if passers.size == 0:
                    continue
                pc = self._gather_chunk_passers(chunks, passers)
                if pc is None:
                    # >cap passers in one chunk (tiny rungs with huge
                    # pass rates): materialize the group matrix once
                    dev = (chunks[0] if len(chunks) == 1
                           else jnp.concatenate(chunks))[:valid]
                    pc = np.asarray(jnp.take(dev, jnp.asarray(passers),
                                             axis=0))
                verify(pc)
                if acc_n >= n:
                    logger.debug(
                        "control search: %d verified passers from %d "
                        "candidates (early exit inside rung %d, %.2fs)",
                        acc_n, searched, rung, time.time() - t_rung)
                    return result(search_mult)
            if not chunked_ok:
                # native engine: exact k=1 for every candidate of the rung
                codes_dev = jnp.concatenate(
                    [sample_codes(jax.random.fold_in(rkey, c), cum,
                                  m=chunk, length=length)
                     for c in range(nchunks)])[:m]
                searched += m
                verify(np.asarray(codes_dev))
                if acc_n >= n:
                    logger.debug("control search: %d verified passers from "
                                 "%d candidates (rung %d, %.2fs)",
                                 acc_n, searched, rung,
                                 time.time() - t_rung)
                    return result(search_mult)
            logger.debug("control rung %d (m=%d): %d/%d verified passers "
                         "after %.2fs; escalating", rung, m, acc_n, n,
                         time.time() - t_rung)
        raise IndexError(
            "Could not find controls with minimum distance %d even with "
            "a search pool of %d" % (minimum_hmdist_target, n * search_mult))

    # ------------------------------------------------------------------
    def launch_control_search(self, fastapath: str, configpath: str,
                              length: int = 20, n: int = 10,
                              num_threads: int = 2,
                              seed: Optional[int] = None):
        """Run the full control-guide search in a background thread.

        The search is independent of annotation/scoring (it only needs
        the already-built index), and its cost is almost entirely device
        time (the rung counting) plus one fasta pass for GC%% — so
        launching it right after ``get_neighbors`` overlaps it with the
        host-bound annotation/Doench/CFD stages.  A subsequent
        ``get_control_seqs`` call with the same parameters joins the
        thread and returns its result; exceptions re-raise at the join.
        """
        import threading
        from .io import parse_fasta

        self._control_args = (configpath, length, n, seed)
        self._control_result = None
        self._control_exc: Optional[BaseException] = None

        def _run():
            t0 = time.time()
            try:
                self._control_result = self._get_control_seqs_now(
                    parse_fasta(fastapath), configpath, length, n,
                    num_threads, seed)
                logger.debug("background control search finished in %.2fs",
                             time.time() - t0)
            except BaseException as exc:   # re-raised by get_control_seqs
                # also log now: if the join is skipped (arg mismatch or
                # caller never joins) the failure must not vanish
                logger.error("background control search failed: %r", exc)
                self._control_exc = exc

        t = threading.Thread(target=_run, name="gm-control-search",
                             daemon=True)
        t.start()
        self._control_thread = t
        return t

    def get_control_seqs(self, seq_record_iter, configpath: str,
                         length: int = 20, n: int = 10,
                         num_threads: int = 2, seed: Optional[int] = None):
        """Random non-targeting controls maximally distant from the genome.

        Replicates core.py:545-633: sample with genome GC composition,
        exact nearest-target distance via the index, keep the n most
        distant, escalate the candidate pool through
        ``CONTROL_SEARCH_MULTIPLE`` until the minimum distance reaches
        ``MINIMUM_HMDIST``.  Raises IndexError when the ladder is
        exhausted (and, unlike the reference, *returns* on success at the
        final rung).  ``seed`` makes the sampling reproducible (the
        reference is unseeded; ``None`` keeps that behavior).

        If :meth:`launch_control_search` was started with the same
        parameters, this joins that thread instead of recomputing.
        """
        # join key: every parameter the search RESULT depends on.
        # ``num_threads`` is deliberately excluded — it is a reference-API
        # parity no-op here (the exact device search has no thread knob,
        # see _get_control_seqs_now), so a differing value must not force
        # a silent recompute of identical work.
        th = getattr(self, "_control_thread", None)
        if (th is not None
                and getattr(self, "_control_args", None)
                == (configpath, length, n, seed)):
            th.join()
            self._control_thread = None
            if self._control_exc is not None:
                raise self._control_exc
            return self._control_result
        if th is not None and th.is_alive():
            logger.warning(
                "control search parameters changed (%r -> %r); recomputing "
                "while the stale background search still runs",
                getattr(self, "_control_args", None),
                (configpath, length, n, seed))
        return self._get_control_seqs_now(seq_record_iter, configpath,
                                          length, n, num_threads, seed)

    def _get_control_seqs_now(self, seq_record_iter, configpath: str,
                              length: int = 20, n: int = 10,
                              num_threads: int = 2,
                              seed: Optional[int] = None):
        with open(configpath) as cf:
            config = yaml.safe_load(cf)
        minimum_hmdist_target = config["CONTROL"]["MINIMUM_HMDIST"]
        multiples = config["CONTROL"]["CONTROL_SEARCH_MULTIPLE"]

        t0 = time.time()
        totlen = 0
        gccnt = 0.0
        for record in seq_record_iter:
            _, seq = record_id_and_seq(record)
            gccnt += dna.gc_fraction(seq) * len(seq)
            totlen += len(seq)
        gc = gccnt / totlen
        self.gc_percent = gc * 100
        self.genomesize = totlen / (1024 * 1024)
        t_gc = time.time()

        th = getattr(self, "_prewarm_thread", None)
        if th is not None:
            th.join(timeout=600)   # let the program loads finish cleanly
        th2 = getattr(self, "_prewarm_thread2", None)
        if th2 is not None:
            th2.join(timeout=600)
        logger.debug("control search: GC pass %.2fs, prewarm join %.2fs",
                     t_gc - t0, time.time() - t_gc)
        sort_seq, sort_dist, search_mult, searched = self._control_search(
            gc, length, n, multiples, minimum_hmdist_target, seed)

        # actual candidates triaged (the reference reports the successful
        # rung's nominal pool size; with cross-rung accumulation + early
        # exit the honest figure is the number actually drawn)
        self.ncontrolsearched = searched
        randomdf = pd.DataFrame(
            data={"Sequences": sort_seq, "Hamming distance": sort_dist})
        randomdf["name"] = randomdf["Sequences"].apply(
            lambda s: "Cont-" + hashlib.md5(s.encode()).hexdigest())
        randomdf = randomdf[["name", "Sequences", "Hamming distance"]]
        return (min(sort_dist), statistics.median(sort_dist), randomdf)
