"""Environment-fallback coverage: the branches that only fire in the
field — compile-cache placement in ``__init__``, native-absent paths,
the pallas-backend driver routes, and save/load round trips."""
import os

import numpy as np
import pytest

import guidemaker_tpu as gm
from guidemaker_tpu import dna
from guidemaker_tpu.knn.driver import KnnIndex


def _seqs(n=300, L=20, seed=11):
    rng = np.random.default_rng(seed)
    return list(dict.fromkeys(
        dna.decode_rows(rng.integers(0, 4, (n, L)).astype(np.uint8))))


# ---------------------------------------------------------------------------
# __init__: persistent compile-cache placement
# ---------------------------------------------------------------------------

@pytest.fixture
def jax_cache_config():
    """Restore the JAX config the cache tests change."""
    import jax
    saved = (jax.config.jax_platforms, jax.config.jax_compilation_cache_dir,
             jax.config.jax_persistent_cache_min_compile_time_secs)
    yield jax
    jax.config.update("jax_platforms", saved[0])
    jax.config.update("jax_compilation_cache_dir", saved[1])
    jax.config.update("jax_persistent_cache_min_compile_time_secs", saved[2])


def test_compile_cache_off_when_pinned_to_cpu(jax_cache_config,
                                              monkeypatch):
    jax = jax_cache_config
    jax.config.update("jax_platforms", "cpu")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    assert gm._configure_compile_cache() is None


def test_compile_cache_uses_env_dir(jax_cache_config, monkeypatch):
    jax = jax_cache_config
    jax.config.update("jax_platforms", "cuda")
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/from/env")
    assert gm._configure_compile_cache() == "/from/env"
    # the env var is JAX's own setting: no other directory is set in code
    assert jax.config.jax_compilation_cache_dir is None
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_compile_cache_fixed_path_in_checkout(jax_cache_config,
                                              monkeypatch):
    jax = jax_cache_config
    jax.config.update("jax_platforms", "cuda")
    jax.config.update("jax_compilation_cache_dir", None)
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    got = gm._configure_compile_cache()
    repo = os.path.dirname(os.path.dirname(os.path.abspath(gm.__file__)))
    assert got == os.path.join(repo, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == got
    # the same path on every call: nothing keyed by host, pid or time
    jax.config.update("jax_compilation_cache_dir", None)
    assert gm._configure_compile_cache() == got


# ---------------------------------------------------------------------------
# driver: backend-selection and native-absent fallbacks
# ---------------------------------------------------------------------------

def test_native_backend_falls_back_to_jax_when_unavailable(monkeypatch):
    from guidemaker_tpu import native
    seqs = _seqs(120)
    idx = KnnIndex(seqs, metric="hamming", backend="native")
    want_d, want_i = KnnIndex(seqs, metric="hamming", backend="xla").query(
        seqs[:20], k=3)
    monkeypatch.setattr(native, "available", lambda: False)
    d, i = idx.query(seqs[:20], k=3)
    np.testing.assert_array_equal(d, want_d)
    np.testing.assert_array_equal(i, want_i)
    # leven native-absent path
    idx_l = KnnIndex(seqs, metric="leven", backend="native")
    dl, il = idx_l.query(seqs[:10], k=2)
    wl, wi = KnnIndex(seqs, metric="leven", backend="xla").query(
        seqs[:10], k=2)
    np.testing.assert_array_equal(dl, wl)
    np.testing.assert_array_equal(il, wi)


def test_native_backend_count_within_unsupported():
    seqs = _seqs(64)
    idx = KnnIndex(seqs, metric="hamming", backend="native")
    codes = np.stack([dna.encode(s) for s in seqs[:8]])
    assert idx.count_within(codes, 2) is None
    assert not idx.supports_chunk_triage(2)
    assert idx.pass_mask_chunks([codes], 2) is None


def test_xla_count_within_matches_bruteforce():
    seqs = _seqs(150)
    idx = KnnIndex(seqs, metric="hamming", backend="xla")
    rng = np.random.default_rng(5)
    codes = rng.integers(0, 4, (33, 20)).astype(np.uint8)
    got = idx.count_within(codes, 3)
    db = np.stack([dna.encode(s) for s in seqs])
    dm = (codes[:, None, :] != db[None, :, :]).sum(2)
    np.testing.assert_array_equal(got, (dm < 3).sum(1))
    # mask variant over two equal-shape chunks
    import jax.numpy as jnp
    pm = idx.pass_mask_chunks([jnp.asarray(codes[:16]),
                               jnp.asarray(codes[16:32])], 3)
    np.testing.assert_array_equal(pm.astype(bool),
                                  (dm[:32] < 3).sum(1) == 0)


def test_index_save_load_roundtrip(tmp_path):
    seqs = _seqs(80)
    idx = KnnIndex(seqs, metric="leven", backend="xla")
    p = str(tmp_path / "idx.npz")
    idx.save(p)
    idx2 = KnnIndex.load(p)
    assert idx2.metric == "leven" and idx2.seqs == idx.seqs
    d1, i1 = idx.query(seqs[:5], k=2)
    d2, i2 = idx2.query(seqs[:5], k=2)
    np.testing.assert_array_equal(d1, d2)
    np.testing.assert_array_equal(i1, i2)


def test_arrow_index_construction_matches_list():
    import pandas as pd
    seqs = _seqs(120)
    col = pd.Series(seqs, dtype="str")
    idx_a = KnnIndex(col, metric="hamming", backend="xla")
    idx_l = KnnIndex(seqs, metric="hamming", backend="xla")
    assert idx_a.seqs == idx_l.seqs       # lazy materialization
    assert len(idx_a.seq_array) == len(seqs)
    d_a, i_a = idx_a.query(col[:16], k=3)
    d_l, i_l = idx_l.query(seqs[:16], k=3)
    np.testing.assert_array_equal(d_a, d_l)
    np.testing.assert_array_equal(i_a, i_l)
    # membership checks through the Arrow path
    assert idx_a._counting_filter_valid(col)
    assert idx_a._counting_filter_valid(pd.Series(seqs[:5], dtype="str"))
    assert not idx_a._counting_filter_valid(
        pd.Series(["A" * 20], dtype="str"))


def test_arrow_index_rejects_ragged_and_duplicates():
    import pandas as pd
    with pytest.raises(ValueError):
        KnnIndex(pd.Series(["ACGT", "ACGTA"], dtype="str"), backend="xla")
    dup = pd.Series(["ACGTACGTAC", "ACGTACGTAC", "TTTTTTTTTT"], dtype="str")
    idx = KnnIndex(dup, backend="xla")
    assert not idx._counting_filter_valid(dup)   # duplicated db


def test_encode_pandas_large_string_and_errors():
    import pandas as pd
    import pyarrow as pa
    seqs = _seqs(40, L=12)
    arr = pa.array(seqs, type=pa.large_string())
    codes, out = dna.encode_pandas(arr)
    np.testing.assert_array_equal(codes,
                                  np.stack([dna.encode(s) for s in seqs]))
    # sliced arrays read from the right buffer offset
    sl = arr.slice(10, 20)
    codes_sl, _ = dna.encode_pandas(sl)
    np.testing.assert_array_equal(codes_sl, codes[10:30])
    with pytest.raises(ValueError):
        dna.encode_pandas(pd.Series(seqs, dtype="str"), length=11)
    empty, _ = dna.encode_pandas(pa.array([], type=pa.string()), length=12)
    assert empty.shape == (0, 12)


def test_hamming_query_codes_on_leven_index_all_backends():
    seqs = _seqs(150)
    codes = np.stack([dna.encode(s) for s in seqs[:12]])
    want_d, want_i = KnnIndex(seqs, metric="hamming",
                              backend="xla").query_codes(codes, 2)
    for backend in ("xla", "native", "sharded"):
        idx = KnnIndex(seqs, metric="leven", backend=backend)
        d, i = idx.hamming_query_codes(codes, 2)
        np.testing.assert_array_equal(d, want_d)
        np.testing.assert_array_equal(i, want_i)


def test_chunked_stream_topk_path(monkeypatch, interpret_kernels):
    """Query sets above one fixed chunk dispatch chunk-wise with a padded
    tail; results must equal the single-dispatch path."""
    import guidemaker_tpu.knn.driver as drv
    monkeypatch.setattr(drv, "_Q_CHUNK", 128)
    seqs = _seqs(400)
    idx = KnnIndex(seqs, metric="hamming", backend="pallas")
    ref = KnnIndex(seqs, metric="hamming", backend="xla")
    d, i = idx.query(seqs[:300], k=3)     # 3 chunks, padded tail
    wd, wi = ref.query(seqs[:300], k=3)
    np.testing.assert_array_equal(d, wd)
    np.testing.assert_array_equal(i, wi)


def test_pallas_stream_filter_and_counts(interpret_kernels):
    """The counting branches of pass_distance_filter / count_within /
    pass_mask_chunks on the pallas backend (interpret mode on CPU)."""
    import jax.numpy as jnp
    seqs = _seqs(1200)
    idx = KnnIndex(seqs, metric="hamming", backend="pallas")
    ref = KnnIndex(seqs, metric="hamming", backend="xla")
    # all-vs-all shortcut (list input) and subset path
    np.testing.assert_array_equal(idx.pass_distance_filter(seqs, 2),
                                  ref.pass_distance_filter(seqs, 2))
    np.testing.assert_array_equal(idx.pass_distance_filter(seqs[:40], 2),
                                  ref.pass_distance_filter(seqs[:40], 2))
    # arrow-typed all-vs-all (the pipeline's route)
    import pandas as pd
    col = pd.Series(seqs, dtype="str")
    idx2 = KnnIndex(col, metric="hamming", backend="pallas")
    np.testing.assert_array_equal(idx2.pass_distance_filter(col, 2),
                                  ref.pass_distance_filter(seqs, 2))
    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, (17, 20)).astype(np.uint8)
    np.testing.assert_array_equal(idx.count_within(codes, 3),
                                  ref.count_within(codes, 3))
    np.testing.assert_array_equal(
        idx.pass_mask_chunks([jnp.asarray(codes)], 3).astype(bool),
        np.asarray(ref.count_within(codes, 3)) == 0)


def test_sharded_backend_leven_query_codes():
    seqs = _seqs(90)
    codes = np.stack([dna.encode(s) for s in seqs[:7]])
    idx = KnnIndex(seqs, metric="leven", backend="sharded")
    ref = KnnIndex(seqs, metric="leven", backend="xla")
    d, i = idx.query_codes(codes, 2)
    wd, wi = ref.query_codes(codes, 2)
    np.testing.assert_array_equal(d, wd)
    np.testing.assert_array_equal(i, wi)


def test_load_backend_override(tmp_path):
    seqs = _seqs(30)
    idx = KnnIndex(seqs, metric="hamming", backend="xla")
    p = str(tmp_path / "i.npz")
    idx.save(p)
    idx2 = KnnIndex.load(p, backend="native")
    assert idx2.backend == "native" and len(idx2) == len(seqs)
