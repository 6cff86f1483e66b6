"""Pallas GPU kernel tests (interpret mode on the CPU; compiled for the
card in tests/test_gpu_hw.py), and the driver's choice of backend."""
import jax.numpy as jnp
import numpy as np
import pytest

from guidemaker_tpu import dna
from guidemaker_tpu.knn import driver as drv
from guidemaker_tpu.knn import pallas_gpu as pg
from guidemaker_tpu.knn.driver import KnnIndex, _default_backend
from guidemaker_tpu.knn.hamming import (hamming_topk, keys_to_neighbors,
                                        onehot_on_device)


def _onehot(rng, n, length):
    return dna.one_hot_matrix(
        rng.integers(0, 4, size=(n, length)).astype(np.uint8))


def _kernel_topk(q_codes, db_codes, k):
    """Top-k kernel (interpret mode) on unpadded code matrices."""
    length = q_codes.shape[1]
    keys = pg.topk_keys(onehot_on_device(jnp.asarray(q_codes)),
                        onehot_on_device(jnp.asarray(db_codes)),
                        jnp.int32(len(db_codes)), k=min(k, len(db_codes)),
                        length=length, interpret=True)
    return keys_to_neighbors(np.asarray(keys), len(db_codes), k)


def _oracle_topk(q, db, k):
    dist = (q[:, None, :] != db[None, :, :]).sum(axis=2).astype(np.int64)
    keys = np.sort(dist * len(db) + np.arange(len(db)), axis=1)[:, :k]
    d = (keys // len(db)).astype(np.int32)
    i = (keys % len(db)).astype(np.int32)
    if k > len(db):
        pad = np.full((len(q), k - len(db)), -1, np.int32)
        d, i = np.concatenate([d, pad], 1), np.concatenate([i, pad], 1)
    return d, i


@pytest.mark.parametrize("nq,nd,k,L", [
    (100, 300, 3, 20), (257, 1025, 10, 27), (64, 64, 2, 12)])
def test_pallas_matches_xla(nq, nd, k, L):
    rng = np.random.default_rng(nq + nd)
    qc = rng.integers(0, 4, size=(nq, L)).astype(np.uint8)
    dc = rng.integers(0, 4, size=(nd, L)).astype(np.uint8)
    d1, i1 = hamming_topk(dna.one_hot_matrix(qc), dna.one_hot_matrix(dc), k, L)
    d2, i2 = _kernel_topk(qc, dc, k)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)


@pytest.mark.parametrize("L", [10, 20, 27])
@pytest.mark.parametrize("k", [1, 3, 5, 10, 20])
def test_topk_kernel_matches_oracle(k, L):
    """Every --knum the CLI accepts class (1..20) at the shortest, the
    default and the longest guide: ties broken by database index, -1
    padding when k exceeds the database."""
    rng = np.random.default_rng(k * 100 + L)
    db = rng.integers(0, 4, size=(300, L)).astype(np.uint8)
    db[5] = db[6]
    db[5, 0] = (db[5, 0] + 1) % 4              # a distance-1 pair
    q = np.concatenate([db[:40], rng.integers(0, 4, size=(30, L))
                        .astype(np.uint8)])
    d, i = _kernel_topk(q, db, k)
    od, oi = _oracle_topk(q, db, k)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(i, oi)


def test_pallas_multi_tile_revisit():
    # many database blocks and database splits per query block: the
    # running top-k carries across blocks and the splits merge outside
    rng = np.random.default_rng(7)
    q = rng.integers(0, 4, size=(64, 20)).astype(np.uint8)
    db = rng.integers(0, 4, size=(1300, 20)).astype(np.uint8)
    d1, i1 = _oracle_topk(q, db, 5)
    d2, i2 = _kernel_topk(q, db, 5)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)


def test_pallas_k_exceeds_db():
    rng = np.random.default_rng(1)
    q = rng.integers(0, 4, size=(8, 20)).astype(np.uint8)
    db = rng.integers(0, 4, size=(3, 20)).astype(np.uint8)
    d, i = _kernel_topk(q, db, 6)
    assert (d[:, 3:] == -1).all() and (i[:, 3:] == -1).all()
    od, oi = _oracle_topk(q, db, 6)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(i, oi)


@pytest.mark.parametrize("editdist", [0, 1, 2, 3, 4, 5])
def test_count_kernel_matches_oracle(editdist):
    """Counting at every --dist, with query and database row counts that
    are not block multiples (zero-feature padding rows on both sides)."""
    rng = np.random.default_rng(31 + editdist)
    codes = rng.integers(0, 4, size=(333, 20)).astype(np.uint8)
    codes[20] = codes[21]
    codes[20, :editdist // 2] = (codes[20, :editdist // 2] + 1) % 4
    q = codes[:97]
    counts = pg.count_within(onehot_on_device(jnp.asarray(q)),
                             onehot_on_device(jnp.asarray(codes)),
                             length=20, editdist=editdist, interpret=True)
    dist = (q[:, None, :] != codes[None, :, :]).sum(axis=2)
    np.testing.assert_array_equal(np.asarray(counts),
                                  (dist < editdist).sum(axis=1))


@pytest.mark.parametrize("platform,n,backend,engine", [
    ("gpu", 1, "pallas", "pallas"), ("cpu", 1, "xla", "xla"),
    ("gpu", 4, "sharded", "pallas"), ("cpu", 8, "sharded", "xla")])
def test_backend_choice_from_platform_and_devices(monkeypatch, platform, n,
                                                  backend, engine):
    monkeypatch.setattr(drv, "_devices", lambda: (platform, n))
    assert _default_backend() == backend
    assert drv._engine(backend) == engine
    assert drv._engine("xla") == "xla" and drv._engine("pallas") == "pallas"


def test_backend_choice_raises_without_a_backend(monkeypatch):
    import jax

    def no_backend():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(jax, "devices", no_backend)
    with pytest.raises(RuntimeError):
        _default_backend()


def test_index_backends_agree():
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), size=20)) for _ in range(300)]
    res = {}
    for backend in ("xla", "native"):
        idx = KnnIndex(seqs, backend=backend)
        res[backend] = idx.query(seqs[:50], 4)
    np.testing.assert_array_equal(res["xla"][0], res["native"][0])
    np.testing.assert_array_equal(res["xla"][1], res["native"][1])


def test_stream_kernel_matches_xla(interpret_kernels):
    """The pallas backend's query path (kernel in interpret mode)."""
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=(700, 20)).astype(np.uint8)
    seqs = dna.decode_rows(codes)
    d_s, i_s = KnnIndex(seqs, backend="pallas").query(seqs[:100], 4)
    d_x, i_x = hamming_topk(dna.one_hot_matrix(codes[:100]),
                            dna.one_hot_matrix(codes), 4, 20)
    np.testing.assert_array_equal(d_s, d_x)
    np.testing.assert_array_equal(i_s, i_x)


def test_stream_kernel_k_exceeds_db(interpret_kernels):
    rng = np.random.default_rng(2)
    seqs = dna.decode_rows(rng.integers(0, 4, size=(3, 20)).astype(np.uint8))
    d, i = KnnIndex(seqs, backend="pallas").query(seqs, 6)
    assert (d[:, 3:] == -1).all() and (i[:, 3:] == -1).all()
    assert (i[:, 0] == np.arange(3)).all()


def test_stream_count_matches_oracle(interpret_kernels):
    rng = np.random.default_rng(31)
    codes = rng.integers(0, 4, size=(600, 20)).astype(np.uint8)
    idx = KnnIndex(dna.decode_rows(codes), backend="pallas")
    dist = (codes[:90, None, :] != codes[None, :, :]).sum(axis=2)
    for editdist in (0, 1, 3, 20):
        counts = idx.count_within(codes[:90], editdist)
        np.testing.assert_array_equal(counts, (dist < editdist).sum(axis=1))


def test_pass_distance_filter_matches_query_threshold():
    # counting path and k=2-query path must agree on retention decisions
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, size=(400, 20)).astype(np.uint8)
    # inject near-duplicates so some guides fail the filter
    codes[10] = codes[11]; codes[12] = codes[13]; codes[12, 0] ^= 1
    seqs = dna.decode_rows(codes)
    idx = KnnIndex(list(dict.fromkeys(seqs)), backend="xla")
    queries = list(dict.fromkeys(seqs))
    dists, _ = idx.query(queries, k=2)
    expect = (dists[:, 1] >= 0) & (dists[:, 1] >= 2)
    got = idx.pass_distance_filter(queries, 2)
    np.testing.assert_array_equal(got, expect)


def test_pass_distance_filter_singleton_db():
    idx = KnnIndex(["ACGTACGTACGTACGTACGT"], backend="xla")
    assert not idx.pass_distance_filter(["ACGTACGTACGTACGTACGT"], 2).any()


def test_pass_distance_filter_nonmember_queries_fall_back():
    """Non-member queries must take the general k=2 path: a non-member
    with exactly one close neighbor in the db would wrongly pass the
    counting shortcut (its 'self-hit' is absent)."""
    rng = np.random.default_rng(9)
    codes = rng.integers(0, 4, size=(300, 20)).astype(np.uint8)
    seqs = list(dict.fromkeys(dna.decode_rows(codes)))
    # non-member query at distance 1 from db entry 0
    qcodes = dna.encode(seqs[0]).copy()
    qcodes[0] ^= 1
    q = dna.decode_rows(qcodes[None, :])[0]
    assert q not in set(seqs)
    for backend in ("xla", "sharded"):
        idx = KnnIndex(seqs, backend=backend)
        got = idx.pass_distance_filter([q, seqs[1]], 2)
        dists, _ = idx.query([q, seqs[1]], k=2)
        expect = (dists[:, 1] >= 0) & (dists[:, 1] >= 2)
        np.testing.assert_array_equal(got, expect)
        # the planted near-duplicate pair: nearest hit is dist 1 -> via the
        # general semantics dists[0]=1 (not self), dists[1] decides
        assert got[0] == expect[0]


def test_pass_distance_filter_duplicated_db_falls_back():
    """A database containing duplicate strings breaks the counting
    invariant (self-hit count 2); driver must detect and fall back."""
    rng = np.random.default_rng(11)
    codes = rng.integers(0, 4, size=(200, 20)).astype(np.uint8)
    seqs = list(dict.fromkeys(dna.decode_rows(codes)))
    dup_seqs = seqs + [seqs[0]]  # duplicate entry
    idx = KnnIndex(dup_seqs, backend="sharded")
    got = idx.pass_distance_filter(dup_seqs[:50], 2)
    dists, _ = idx.query(dup_seqs[:50], k=2)
    expect = (dists[:, 1] >= 0) & (dists[:, 1] >= 2)
    np.testing.assert_array_equal(got, expect)
    assert not got[0]  # the duplicated guide has a 0-distance neighbor


def test_pass_mask_chunks_matches_within_and_oracle(interpret_kernels):
    """The fixed-shape chunked triage (one counting executable for every
    control rung) must agree with count_within and the numpy oracle,
    including tail rows beyond the rung size."""
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=(500, 20)).astype(np.uint8)
    idx = KnnIndex(dna.decode_rows(codes), backend="pallas")
    cand = rng.integers(0, 4, size=(700, 20)).astype(np.uint8)
    cand[5] = codes[3]                      # exact member -> close hit
    cand[40] = codes[8]; cand[40, 0] ^= 1   # distance-1 neighbor
    for editdist in (1, 7):
        dist = (cand[:, None, :] != codes[None, :, :]).sum(axis=2)
        oracle = ((dist < editdist).sum(axis=1) == 0).astype(np.uint8)
        np.testing.assert_array_equal(
            idx.count_within(jnp.asarray(cand), editdist) == 0,
            oracle.astype(bool))
        # equal-shape chunks, including a row count that is NOT a
        # block multiple
        for rows in (384, 350):
            pad = np.concatenate(
                [cand, rng.integers(0, 4, size=(2 * rows - 700, 20),
                                    dtype=np.uint8)])
            chunks = [jnp.asarray(pad[:rows]), jnp.asarray(pad[rows:])]
            got_chunks = idx.pass_mask_chunks(chunks, editdist)
            assert got_chunks.shape == (2 * rows,)
            np.testing.assert_array_equal(got_chunks[:700], oracle)
