"""Multi-device sharded k-NN tests on the virtual 8-device CPU mesh."""
import jax
import numpy as np
import pytest

from guidemaker_tpu import dna
from guidemaker_tpu.knn.hamming import hamming_topk
from guidemaker_tpu.knn.sharded import make_mesh, sharded_hamming_topk


def _onehot(rng, n, length):
    codes = rng.integers(0, 4, size=(n, length)).astype(np.uint8)
    return dna.one_hot_matrix(codes)


@pytest.fixture(scope="module", autouse=True)
def require_devices():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices (see conftest XLA_FLAGS)")


@pytest.mark.parametrize("q_shards,d_shards", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_matches_single_device(q_shards, d_shards):
    rng = np.random.default_rng(q_shards * 10 + d_shards)
    q = _onehot(rng, 96, 20)
    db = _onehot(rng, 1000, 20)
    mesh = make_mesh(q_shards, d_shards)
    d_sh, i_sh = sharded_hamming_topk(q, db, 5, 20, mesh=mesh)
    d_1, i_1 = hamming_topk(q, db, 5, 20)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)


def test_sharded_unaligned_sizes():
    # db and query sizes that don't divide the mesh evenly
    rng = np.random.default_rng(3)
    q = _onehot(rng, 37, 17)
    db = _onehot(rng, 531, 17)
    mesh = make_mesh(2, 4)
    d_sh, i_sh = sharded_hamming_topk(q, db, 4, 17, mesh=mesh)
    d_1, i_1 = hamming_topk(q, db, 4, 17)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)


def test_sharded_k_exceeds_db():
    rng = np.random.default_rng(5)
    q = _onehot(rng, 8, 12)
    db = _onehot(rng, 3, 12)
    mesh = make_mesh(1, 8)
    d_sh, i_sh = sharded_hamming_topk(q, db, 6, 12, mesh=mesh)
    assert (d_sh[:, 3:] == -1).all()
    d_1, i_1 = hamming_topk(q, db, 6, 12)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)


def test_mesh_shape_does_not_change_results():
    rng = np.random.default_rng(11)
    q = _onehot(rng, 64, 20)
    db = _onehot(rng, 512, 20)
    results = []
    for qs, ds in [(1, 8), (2, 4), (8, 1)]:
        mesh = make_mesh(qs, ds)
        results.append(sharded_hamming_topk(q, db, 3, 20, mesh=mesh))
    for d2, i2 in results[1:]:
        np.testing.assert_array_equal(results[0][0], d2)
        np.testing.assert_array_equal(results[0][1], i2)


def _fused_topk(qc, sdb, k):
    from guidemaker_tpu.knn.sharded import put_query_codes, sharded_topk
    return sharded_topk(put_query_codes(qc, sdb.mesh), len(qc), sdb, k,
                        engine="pallas")


@pytest.mark.parametrize("q_shards,d_shards", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_fused_sharded_topk_matches_single_device(q_shards, d_shards,
                                                  interpret_kernels):
    """The GPU-kernel engine wrapped in shard_map must agree bit-for-bit
    with the single-device path on every mesh shape."""
    from guidemaker_tpu.knn.sharded import prepare_db_sharded
    rng = np.random.default_rng(q_shards * 100 + d_shards)
    codes = rng.integers(0, 4, size=(1000, 20)).astype(np.uint8)
    qc = rng.integers(0, 4, size=(96, 20)).astype(np.uint8)
    mesh = make_mesh(q_shards, d_shards)
    sdb = prepare_db_sharded(codes, mesh)
    d_sh, i_sh = _fused_topk(qc, sdb, 5)
    d_1, i_1 = hamming_topk(dna.one_hot_matrix(qc), dna.one_hot_matrix(codes),
                            5, 20)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)


def test_fused_sharded_unaligned_and_k_exceeds_db(interpret_kernels):
    from guidemaker_tpu.knn.sharded import prepare_db_sharded
    rng = np.random.default_rng(23)
    codes = rng.integers(0, 4, size=(531, 17)).astype(np.uint8)
    qc = rng.integers(0, 4, size=(37, 17)).astype(np.uint8)
    mesh = make_mesh(2, 4)
    sdb = prepare_db_sharded(codes, mesh)
    d_sh, i_sh = _fused_topk(qc, sdb, 4)
    d_1, i_1 = hamming_topk(dna.one_hot_matrix(qc),
                            dna.one_hot_matrix(codes), 4, 17)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)
    # k exceeding the db size pads with -1, exactly like hamming_topk
    tiny = codes[:3]
    sdb2 = prepare_db_sharded(tiny, make_mesh(1, 8))
    d_sh, i_sh = _fused_topk(qc[:8], sdb2, 6)
    d_1, i_1 = hamming_topk(dna.one_hot_matrix(qc[:8]),
                            dna.one_hot_matrix(tiny), 6, 17)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)
    assert (d_sh[:, 3:] == -1).all()


@pytest.mark.parametrize("engine", ["xla", "pallas"])
def test_fused_sharded_count_matches_oracle(engine, interpret_kernels):
    from guidemaker_tpu.knn.sharded import (prepare_db_sharded,
                                            put_query_codes, sharded_count)
    rng = np.random.default_rng(29)
    codes = rng.integers(0, 4, size=(500, 20)).astype(np.uint8)
    codes[3] = codes[4]
    codes[4, 0] ^= 1
    dist = (codes[:, None, :] != codes[None, :, :]).sum(axis=2)
    for q_s, d_s in ((2, 4), (1, 8), (4, 2)):
        mesh = make_mesh(q_s, d_s, devices=jax.devices()[:q_s * d_s])
        sdb = prepare_db_sharded(codes, mesh)
        q = put_query_codes(codes, mesh)
        for e in (1, 2, 5):
            counts = np.asarray(sharded_count(q, sdb, e, engine=engine))
            np.testing.assert_array_equal(counts[:500],
                                          (dist < e).sum(axis=1))


def test_knn_index_sharded_backend_matches_xla():
    """KnnIndex(backend='sharded') routes through the fused tier, caches
    the sharded device db, and agrees with the xla backend."""
    from guidemaker_tpu.knn.driver import KnnIndex
    from guidemaker_tpu.knn.sharded import ShardedDb
    rng = np.random.default_rng(31)
    seqs = list({"".join(rng.choice(list("ACGT"), 20)) for _ in range(400)})
    idx_sh = KnnIndex(seqs, "hamming", backend="sharded")
    idx_xla = KnnIndex(seqs, "hamming", backend="xla")
    d_sh, i_sh = idx_sh.query(seqs[:64], k=4)
    d_1, i_1 = idx_xla.query(seqs[:64], k=4)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)
    assert isinstance(idx_sh._db_dev, ShardedDb)  # cached, not re-put
    db_before = idx_sh._db_dev
    passed = idx_sh.pass_distance_filter(seqs, editdist=3)
    expect = idx_xla.pass_distance_filter(seqs, editdist=3)
    np.testing.assert_array_equal(passed, expect)
    assert idx_sh._db_dev is db_before


def test_sharded_count_matches_oracle():
    import numpy as np
    from guidemaker_tpu import dna
    from guidemaker_tpu.knn.sharded import make_mesh, sharded_hamming_count
    import jax
    rng = np.random.default_rng(17)
    codes = rng.integers(0, 4, size=(500, 20)).astype(np.uint8)
    codes[3] = codes[4]; codes[4, 0] ^= 1
    oh = dna.one_hot_matrix(codes)
    dist = (codes[:, None, :] != codes[None, :, :]).sum(axis=2)
    for q_s, d_s in ((2, 4), (1, 8), (4, 2)):
        mesh = make_mesh(q_s, d_s, devices=jax.devices()[:q_s * d_s])
        for e in (1, 2, 5):
            counts = sharded_hamming_count(oh, oh, e, 20, mesh=mesh)
            np.testing.assert_array_equal(counts, (dist < e).sum(axis=1))


# ---------------------------------------------------------------------------
# Levenshtein sharded tiers (VERDICT r2: sharded_leven_topk had no tests)
# ---------------------------------------------------------------------------

def _codes(rng, n, length):
    return rng.integers(0, 4, size=(n, length)).astype(np.uint8)


@pytest.mark.parametrize("q_shards,d_shards", [(1, 8), (2, 4), (4, 2), (8, 1)])
def test_sharded_leven_topk_matches_single_device(q_shards, d_shards):
    from guidemaker_tpu.knn.leven import leven_topk
    from guidemaker_tpu.knn.sharded import sharded_leven_topk
    rng = np.random.default_rng(q_shards * 100 + d_shards)
    q = _codes(rng, 48, 20)
    db = _codes(rng, 700, 20)
    mesh = make_mesh(q_shards, d_shards)
    d_sh, i_sh = sharded_leven_topk(q, db, 4, mesh=mesh, db_tile=128)
    d_1, i_1 = leven_topk(q, db, 4, db_tile=128)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)


def test_sharded_leven_topk_unaligned_and_k_exceeds():
    from guidemaker_tpu.knn.leven import leven_topk
    from guidemaker_tpu.knn.sharded import sharded_leven_topk
    rng = np.random.default_rng(17)
    q = _codes(rng, 19, 13)
    db = _codes(rng, 5, 13)
    mesh = make_mesh(2, 4)
    d_sh, i_sh = sharded_leven_topk(q, db, 7, mesh=mesh, db_tile=64)
    d_1, i_1 = leven_topk(q, db, 7, db_tile=64)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)
    assert (d_sh[:, 5:] == -1).all()


@pytest.mark.parametrize("d_shards", [4, 8])
def test_sharded_leven_pass_filter_matches_single_device(d_shards):
    from guidemaker_tpu.knn.leven import leven_pass_filter
    rng = np.random.default_rng(d_shards)
    # deduplicated db; queries are members (driver preconditions)
    db = np.unique(_codes(rng, 400, 20), axis=0)
    mesh = make_mesh(8 // d_shards, d_shards)
    got = leven_pass_filter(db, db, 3, mesh=mesh)
    want = leven_pass_filter(db, db, 3)
    np.testing.assert_array_equal(got, want)


def test_driver_sharded_leven_retention_routes_through_mesh():
    from guidemaker_tpu.knn.driver import KnnIndex
    rng = np.random.default_rng(23)
    seqs = list(dict.fromkeys(dna.decode_rows(_codes(rng, 300, 20))))
    idx = KnnIndex(seqs, metric="leven", backend="sharded")
    got = idx.pass_distance_filter(seqs, 3)
    exact = KnnIndex(seqs, metric="leven", backend="xla")
    want = exact.pass_distance_filter(seqs, 3)
    np.testing.assert_array_equal(got, want)


def test_sharded_leven_filter_e4_all_tiers_on_mesh():
    """e=4 retention with near-duplicate clusters drives the FULL tier
    cascade — sharded candidate extraction, mesh-wide banded pair
    verification (sharded_banded_pairs), direction-2 sharded counting,
    and the sharded full-DP residue — and must equal the single-device
    decision (round-5: the verification tiers shard too)."""
    from guidemaker_tpu.knn.leven import leven_pass_filter
    rng = np.random.default_rng(41)
    base = rng.integers(0, 4, size=(120, 20)).astype(np.uint8)
    muts = []
    for r in base[:40]:           # 1-3 substitutions: leven 1-3 clusters
        m = r.copy()
        for _ in range(int(rng.integers(1, 4))):
            m[rng.integers(0, 20)] = rng.integers(0, 4)
        muts.append(m)
    for r in base[40:60]:         # one-shift copies: indel-type pairs
        muts.append(np.concatenate([r[1:], rng.integers(0, 4, 1)
                                    .astype(np.uint8)]))
    db = np.unique(np.concatenate([base, np.array(muts)]), axis=0)
    mesh = make_mesh(2, 4)
    got = leven_pass_filter(db, db, 4, mesh=mesh, filter_k=4)
    want = leven_pass_filter(db, db, 4, filter_k=4)
    np.testing.assert_array_equal(got, want)
    assert not want.all() and want.any()


def test_sharded_banded_pairs_matches_single_device():
    from guidemaker_tpu.knn.leven import banded_leven_pairs
    from guidemaker_tpu.knn.sharded import sharded_banded_pairs
    import jax.numpy as jnp
    rng = np.random.default_rng(7)
    a = rng.integers(0, 4, size=(53, 20)).astype(np.uint8)
    b = a.copy()
    for i in range(0, 53, 3):
        b[i, rng.integers(0, 20)] = rng.integers(0, 4)
    mesh = make_mesh(2, 4)
    got = sharded_banded_pairs(a, b, t=3, length=20, mesh=mesh)
    want = np.asarray(banded_leven_pairs(jnp.asarray(a), jnp.asarray(b),
                                         t=3, length=20))
    np.testing.assert_array_equal(got, want)
