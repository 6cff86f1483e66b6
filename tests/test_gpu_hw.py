"""Card tier: the Pallas GPU kernels compiled for a real GPU.

The main suite runs on the CPU, where the kernels run under
``interpret=True`` (tests/test_pallas.py); these tests run the same
kernels compiled for the card against numpy oracles.  On a GPU host::

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q

Without a card every test here skips (the ``gpu`` fixture decides).
"""
import numpy as np
import pytest

pytestmark = pytest.mark.gpu

LENGTH = 20


def _unique_codes(n, length=LENGTH, seed=0):
    rng = np.random.default_rng(seed)
    codes = np.unique(rng.integers(0, 4, size=(n + n // 8, length))
                      .astype(np.uint8), axis=0)
    return codes[rng.permutation(len(codes))[:n]]


def _hamming(q, db):
    return (q[:, None, :] != db[None, :, :]).sum(axis=2)


def _oracle_topk(q, db, k):
    """Exact (distance, index) top-k, tie-broken by database index."""
    keys = _hamming(q, db).astype(np.int64) * len(db) + np.arange(len(db))
    part = np.sort(keys, axis=1)[:, :k]
    return (part // len(db)).astype(np.int32), (part % len(db)).astype(np.int32)


def test_count_kernel_matches_oracle_on_gpu(gpu):
    import jax.numpy as jnp
    from guidemaker_tpu.knn import pallas_gpu as pg
    from guidemaker_tpu.knn.hamming import onehot_on_device, prepare_db
    codes = _unique_codes(5000, seed=1)
    codes[10] = codes[11]
    codes[10, 0] = (codes[10, 0] + 1) % 4
    db = prepare_db(codes)
    q = onehot_on_device(jnp.asarray(codes[:700]))
    dist = _hamming(codes[:700], codes)
    for e in range(6):
        got = np.asarray(pg.count_within(q, db, length=LENGTH, editdist=e))
        np.testing.assert_array_equal(got, (dist < e).sum(axis=1))


@pytest.mark.parametrize("k", [1, 3, 20])
def test_topk_kernel_matches_oracle_on_gpu(gpu, k):
    import jax.numpy as jnp
    from guidemaker_tpu.knn import pallas_gpu as pg
    from guidemaker_tpu.knn.hamming import (keys_to_neighbors,
                                            onehot_on_device, prepare_db)
    codes = _unique_codes(3000, seed=2)
    db = prepare_db(codes)
    q = onehot_on_device(jnp.asarray(codes[:300]))
    keys = pg.topk_keys(q, db, jnp.int32(len(codes)), k=k, length=LENGTH)
    d, i = keys_to_neighbors(np.asarray(keys), len(codes), k)
    od, oi = _oracle_topk(codes[:300], codes, k)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(i, oi)


def test_gram_width_count_kernel_matches_xla_on_gpu(gpu):
    """K = 1152 (18 x 64 gram features): the chunked contraction."""
    import jax.numpy as jnp
    from guidemaker_tpu.knn import pallas_gpu as pg
    from guidemaker_tpu.knn.hamming import count_feats
    from guidemaker_tpu.knn.leven import _gram_feats_on_device
    codes = _unique_codes(4000, seed=3)
    db = _gram_feats_on_device(jnp.asarray(codes), t=3)
    q = _gram_feats_on_device(jnp.asarray(codes[:512]), t=0)
    got = np.asarray(pg.count_within(q, db, length=18, editdist=10))
    want = np.asarray(count_feats(q, db, length=18, editdist=10,
                                  engine="xla"))
    np.testing.assert_array_equal(got, want)


def test_pallas_backend_index_on_gpu(gpu):
    from guidemaker_tpu import dna
    from guidemaker_tpu.knn import KnnIndex
    codes = _unique_codes(6000, seed=4)
    codes[7] = codes[9]
    codes[7, 3] = (codes[7, 3] + 2) % 4
    seqs = dna.decode_rows(codes)
    idx = KnnIndex(seqs, metric="hamming", backend="pallas")
    d, i = idx.query(seqs[:256], k=4)
    od, oi = _oracle_topk(codes[:256], codes, 4)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(i, oi)
    got = idx.pass_distance_filter(seqs, editdist=2)
    d2, _ = _oracle_topk(codes, codes, 2)
    np.testing.assert_array_equal(got, d2[:, 1] >= 2)
    assert not got[7] and not got[9]


def test_sharded_pallas_engine_on_1device_mesh_on_gpu(gpu):
    import jax
    from guidemaker_tpu.knn.sharded import (make_mesh, prepare_db_sharded,
                                            put_query_codes, sharded_count,
                                            sharded_topk)
    mesh = make_mesh(1, 1, devices=jax.devices()[:1])
    codes = _unique_codes(2048, seed=7)
    sdb = prepare_db_sharded(codes, mesh)
    q = put_query_codes(codes[:128], mesh)
    d, i = sharded_topk(q, 128, sdb, 3, engine="pallas")
    od, oi = _oracle_topk(codes[:128], codes, 3)
    np.testing.assert_array_equal(d, od)
    np.testing.assert_array_equal(i, oi)
    counts = np.asarray(sharded_count(q, sdb, 3, engine="pallas"))[:128]
    np.testing.assert_array_equal(counts,
                                  (_hamming(codes[:128], codes) < 3).sum(1))


@pytest.mark.parametrize("e", [2, 3, 4])
def test_leven_retention_engines_agree_on_gpu(gpu, e):
    from guidemaker_tpu.knn.leven import leven_pass_filter, leven_topk
    base = _unique_codes(1500, seed=8)
    muts = base[:200].copy()
    muts[:, 5] = (muts[:, 5] + 1) % 4
    shifted = np.concatenate([base[200:300, 1:], base[200:300, :1]], axis=1)
    db = np.unique(np.concatenate([base, muts, shifted]), axis=0)
    got = leven_pass_filter(db, db, e, engine="pallas")
    np.testing.assert_array_equal(
        got, leven_pass_filter(db, db, e, engine="xla"))
    d2, _ = leven_topk(db, db, 2)
    np.testing.assert_array_equal(got, d2[:, 1] >= e)


def test_delset_join_device_matches_host_on_gpu(gpu):
    import jax.numpy as jnp
    from guidemaker_tpu.knn.leven import (_delset_partner_device,
                                          _delset_partner_mask)
    codes = _unique_codes(20000, seed=9)
    codes[5] = np.concatenate([codes[6, 1:], codes[6, :1]])
    got = np.asarray(_delset_partner_device(jnp.asarray(codes),
                                            length=LENGTH))
    np.testing.assert_array_equal(got, _delset_partner_mask(codes))
