"""TargetProcessor tests mirroring the reference suite (test_core.py:85-155)."""
import numpy as np
import pandas as pd
import pytest

from guidemaker_tpu import PamTarget, TargetProcessor
from guidemaker_tpu.io import parse_fasta


def _fixture_targets():
    # 3-row fixture from reference test_core.py:67-82
    tardict = {
        "target": ["AAATGGTACGTTATGTGTTA", "AAATGGTACGTTATGTGTTA",
                   "AACAGTAAAATGGTTTAATG"],
        "exact_pam": ["AGG", "TGG", "CGG"],
        "start": [35, 41, 158572],
        "stop": [55, 61, 158592],
        "strand": [True, True, False],
        "pam_orientation": [False, False, False],
        "target_seq30": ["TTAGGAAATGGTACGTTATGTGTTATAAGA",
                         "AATGGTACGTTATGTGTTATAAGAATTTCT",
                         "AACGGAACAGTAAAATGGTTTAATGATACA"],
        "seqid": ["AP009180.1", "AP009180.2", "AP009180.1"],
        "seedseq": [None] * 3,
        "isseedduplicated": [None] * 3,
        "hasrestrictionsite": [None] * 3,
        "dtype": ["hamming"] * 3,
    }
    targets = pd.DataFrame(tardict)
    return targets.astype({
        "target": "str", "exact_pam": "category", "start": "uint32",
        "stop": "uint32", "strand": "bool", "pam_orientation": "bool",
        "seqid": "category"})


def test_check_restriction_enzymes():
    tl = TargetProcessor(targets=_fixture_targets(), lsr=10, editdist=2, knum=2)
    tl.check_restriction_enzymes(["NGGTAB"])
    assert tl.targets["hasrestrictionsite"][0] == True  # noqa: E712


def test_check_restriction_enzymes_empty():
    tl = TargetProcessor(targets=_fixture_targets(), lsr=10, editdist=2, knum=2)
    tl.check_restriction_enzymes([])
    assert (tl.targets["hasrestrictionsite"] == False).all()  # noqa: E712


def test_find_unique_near_pam():
    tl = TargetProcessor(targets=_fixture_targets(), lsr=10, editdist=2, knum=2)
    tl.check_restriction_enzymes(["NGGTAB"])
    tl.find_unique_near_pam()
    assert tl.targets[tl.targets["isseedduplicated"] == False].shape == (2, 12)  # noqa: E712


def test_seedseq_orientation():
    # 3prime PAM (pam_orientation False) -> seed is the PAM-proximal suffix
    tl = TargetProcessor(targets=_fixture_targets(), lsr=5, editdist=2, knum=2)
    tl.find_unique_near_pam()
    assert tl.targets["seedseq"][0] == "TGTTA"


def test_get_neighbors_golden(configpath):
    # reference golden: second-nearest distance 12 (test_core.py:116-126)
    tl = TargetProcessor(targets=_fixture_targets(), lsr=10, editdist=2, knum=2)
    tl.check_restriction_enzymes(["NRAGCA"])
    tl.find_unique_near_pam()
    tl.create_index(configpath=configpath)
    tl.get_neighbors(configpath=configpath)
    assert tl.neighbors["AAATGGTACGTTATGTGTTA"]["neighbors"]["dist"][1] == 12
    # neighbor sequences correspond to the reported distances (our fix of
    # the reference's set-ordering bug): nearest is self
    nb = tl.neighbors["AAATGGTACGTTATGTGTTA"]["neighbors"]
    assert nb["seqs"][0] == "AAATGGTACGTTATGTGTTA"
    assert nb["seqs"][1] == "AACAGTAAAATGGTTTAATG"


def test_export_bed(configpath):
    tl = TargetProcessor(targets=_fixture_targets(), lsr=10, editdist=2, knum=10)
    tl.check_restriction_enzymes(["NRAGCA"])
    tl.find_unique_near_pam()
    tl.create_index(configpath=configpath)
    tl.get_neighbors(configpath=configpath)
    df = tl.export_bed()
    assert df.shape == (2, 5)
    assert list(df.columns) == ["chrom", "chromstart", "chromend", "name", "strand"]
    assert set(df["strand"]) <= {"+", "-"}


def test_get_control_seqs(genome_fasta, configpath):
    # reference shape golden (test_core.py:144-155)
    pamobj = PamTarget("NGG", "5prime", "hamming")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=10)
    tl.check_restriction_enzymes(["NRAGCA"])
    tl.find_unique_near_pam()
    tl.create_index(configpath=configpath)
    data = tl.get_control_seqs(parse_fasta(genome_fasta), length=20, n=100,
                               num_threads=2, configpath=configpath)
    assert data[2].shape == (100, 3)
    assert data[0] >= 7  # MINIMUM_HMDIST reached
    assert list(data[2].columns) == ["name", "Sequences", "Hamming distance"]
    assert data[2]["name"].str.startswith("Cont-").all()
    assert tl.gc_percent is not None and tl.genomesize is not None


def test_neighbors_or_filter_quirk(configpath):
    # the reference queries targets that are seed-unique OR restriction-free
    # (core.py:495) — a seed-duplicated but restriction-free target IS queried
    targets = _fixture_targets()
    tl = TargetProcessor(targets=targets, lsr=10, editdist=0, knum=2)
    tl.check_restriction_enzymes([])          # nothing flagged
    tl.find_unique_near_pam()                 # row 1 is a seed duplicate
    tl.create_index(configpath=configpath)
    tl.get_neighbors(configpath=configpath)
    # with editdist=0 every queried target passes; dedup means 2 unique keys
    assert len(tl.neighbors) == 2


def test_lazy_neighbors_dict_matches_neighbor_frame(configpath):
    # the lazily-built reference-shaped dict and the vectorized
    # neighbor_frame must agree on every passing guide
    targets = _fixture_targets()
    tl = TargetProcessor(targets=targets, lsr=10, editdist=1, knum=2)
    tl.check_restriction_enzymes([])
    tl.find_unique_near_pam()
    tl.create_index(configpath=configpath)
    tl.get_neighbors(configpath=configpath)
    seqs = tl.passing_seqs()
    assert seqs, "fixture should have passing guides"
    frame = tl.neighbor_frame(seqs)
    nd = tl.neighbors  # materializes the dict lazily
    for _, row in frame.iterrows():
        entry = nd[row["Guide sequence"]]["neighbors"]
        assert row["Similar guides"] == ";".join(entry["seqs"])
        assert row["Similar guide distances"] == ";".join(
            str(d) for d in entry["dist"])


def test_control_seqs_seed_reproducible(genome_fasta, configpath):
    pamobj = PamTarget("ATGA", "5prime", "hamming")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl.find_unique_near_pam()
    tl.check_restriction_enzymes([])
    tl.create_index(configpath=configpath)
    _, _, df1 = tl.get_control_seqs(parse_fasta(genome_fasta),
                                    configpath=configpath, length=20, n=12,
                                    seed=42)
    _, _, df2 = tl.get_control_seqs(parse_fasta(genome_fasta),
                                    configpath=configpath, length=20, n=12,
                                    seed=42)
    pd.testing.assert_frame_equal(df1, df2)
    _, _, df3 = tl.get_control_seqs(parse_fasta(genome_fasta),
                                    configpath=configpath, length=20, n=12,
                                    seed=43)
    assert not df1["Sequences"].tolist() == df3["Sequences"].tolist()


def test_neighbors_setter_invalidates_arrays(configpath):
    """Assigning .neighbors must drop materialized (dists, idxs) arrays
    so neighbor_frame recomputes instead of indexing stale rows."""
    targets = _fixture_targets()
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl.find_unique_near_pam()
    tl.check_restriction_enzymes([])
    tl.create_index(configpath=configpath)
    tl.get_neighbors(configpath=configpath)
    tl._neighbor_arrays()  # materialize
    assert tl._nb_dists is not None
    keep = tl.passing_seqs()[:1]
    tl.neighbors = {s: tl.neighbors[s] for s in keep}
    assert tl._nb_dists is None and tl._nb_idxs is None
    frame = tl.neighbor_frame(keep)
    assert frame["Guide sequence"].tolist() == keep


def test_get_control_seqs_leven(genome_fasta, configpath):
    """Controls on a Levenshtein index are screened by HAMMING distance —
    the control rule's own definition (config key MINIMUM_HMDIST, output
    column "Hamming distance"); ranking by the leven index's distances
    (the reference quirk) exhausts the ladder at genome scale because
    leven <= hamming.  Documented divergence, PARITY.md."""
    import numpy as np

    pamobj = PamTarget("NGG", "5prime", "leven")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=3)
    tl.check_restriction_enzymes([])
    tl.find_unique_near_pam()
    tl.create_index(configpath=configpath)
    assert tl.index.metric == "leven"
    cmin, cmed, df = tl.get_control_seqs(parse_fasta(genome_fasta),
                                         length=20, n=20, num_threads=2,
                                         configpath=configpath, seed=3)
    assert cmin >= 7 and df.shape == (20, 3)
    # reported values = exact HAMMING nearest via the metric-agnostic path
    from guidemaker_tpu import dna
    codes = np.stack([dna.encode(s) for s in df["Sequences"]])
    d, _ = tl.index.hamming_query_codes(codes, k=1)
    np.testing.assert_array_equal(
        d[:, 0], df["Hamming distance"].to_numpy().astype(np.int32))
    # spot-check 3 controls against a pure-python hamming oracle
    for s, want in list(zip(df["Sequences"], df["Hamming distance"]))[:3]:
        best = min(sum(a != b for a, b in zip(s, t)) for t in tl.index.seqs)
        assert best == int(want)
        # the leven nearest may be closer — never farther
        d_lev, _ = tl.index.query([s], k=1)
        assert d_lev[0, 0] <= int(want)


def test_control_seqs_pallas_chunked_ladder(genome_fasta, configpath,
                                            monkeypatch, interpret_kernels):
    """The fixed-shape chunked triage + per-chunk passer gather must
    produce valid controls on the pallas backend (the one-GPU default;
    kernels in interpret mode here)."""
    import guidemaker_tpu.knn.driver as drv
    monkeypatch.setattr(drv, "_default_backend", lambda: "pallas")
    pamobj = PamTarget("ATGA", "5prime", "hamming")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl.find_unique_near_pam()
    tl.check_restriction_enzymes([])
    tl.create_index(configpath=configpath)
    assert tl.index.backend == "pallas"
    cmin, cmed, df = tl.get_control_seqs(parse_fasta(genome_fasta),
                                         configpath=configpath, length=20,
                                         n=12, seed=42)
    assert cmin >= 7 and len(df) == 12
    # reported distances are the exact nearest-target distances
    import numpy as np
    d, _ = tl.index.query(df["Sequences"].tolist(), k=1)
    np.testing.assert_array_equal(
        d[:, 0], df["Hamming distance"].to_numpy().astype(np.int32))
    # deterministic given the seed (chunked threefry streams)
    _, _, df2 = tl.get_control_seqs(parse_fasta(genome_fasta),
                                    configpath=configpath, length=20,
                                    n=12, seed=42)
    assert df["Sequences"].tolist() == df2["Sequences"].tolist()


def test_control_ladder_fallback_paths(genome_fasta, configpath, tmp_path,
                                       monkeypatch):
    """Covers the rarely-hit control-search branches: the rung-wide
    gather fallback (>_PASSER_CAP passers per chunk at tiny db sizes)
    on the pallas backend, a multi-chunk rung on the xla backend, the
    native engine's exact-k=1 rung, and ladder exhaustion
    (IndexError)."""
    import functools
    import yaml
    import guidemaker_tpu.knn.driver as drv
    from guidemaker_tpu.knn import pallas_gpu as pg

    pamobj = PamTarget("ATGAC", "5prime", "hamming")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    base = yaml.safe_load(open(configpath))

    # (a) pallas backend, huge pass rate -> gather-cap fallback; early
    # exit inside the first rung
    monkeypatch.setattr(drv, "_default_backend", lambda: "pallas")
    monkeypatch.setattr(pg, "count_within",
                        functools.partial(pg.count_within, interpret=True))
    monkeypatch.setattr(pg, "topk_keys",
                        functools.partial(pg.topk_keys, interpret=True))
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl.find_unique_near_pam()
    tl.check_restriction_enzymes([])
    tl.create_index(configpath=configpath)
    cmin, cmed, df = tl.get_control_seqs(parse_fasta(genome_fasta),
                                         configpath=configpath, length=20,
                                         n=9, seed=5)
    assert cmin >= base["CONTROL"]["MINIMUM_HMDIST"] and len(df) == 9
    monkeypatch.undo()

    # (b) xla backend, multi-chunk rung (m > chunk rows)
    cfg2 = dict(base)
    cfg2["CONTROL"] = {"MINIMUM_HMDIST": 7,
                       "CONTROL_SEARCH_MULTIPLE": [1, 300]}
    p2 = tmp_path / "cfg2.yaml"
    p2.write_text(yaml.safe_dump(cfg2))
    tl2 = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl2.find_unique_near_pam()
    tl2.check_restriction_enzymes([])
    tl2.create_index(configpath=str(p2))
    tl2.index.backend = "xla"
    cmin2, _, df2 = tl2.get_control_seqs(parse_fasta(genome_fasta),
                                         configpath=str(p2), length=20,
                                         n=40, seed=6)
    assert cmin2 >= 7 and len(df2) == 40
    # native engine: no counting pass, exact k=1 for the whole rung
    tl2.index.backend = "native"
    cmin2n, _, df2n = tl2.get_control_seqs(parse_fasta(genome_fasta),
                                           configpath=str(p2), length=20,
                                           n=40, seed=6)
    assert cmin2n >= 7 and len(df2n) == 40

    # (c) ladder exhaustion raises IndexError (reference contract)
    cfg3 = dict(base)
    cfg3["CONTROL"] = {"MINIMUM_HMDIST": 20,
                       "CONTROL_SEARCH_MULTIPLE": [2, 4]}
    p3 = tmp_path / "cfg3.yaml"
    p3.write_text(yaml.safe_dump(cfg3))
    tl3 = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl3.find_unique_near_pam()
    tl3.check_restriction_enzymes([])
    tl3.create_index(configpath=str(p3))
    with pytest.raises(IndexError, match="Could not find controls"):
        tl3.get_control_seqs(parse_fasta(genome_fasta), configpath=str(p3),
                             length=20, n=5, seed=7)


def test_control_search_param_mismatch_warns_and_recomputes(
        genome_fasta, configpath, caplog):
    import logging as _logging
    pamobj = PamTarget("ATGAC", "5prime", "hamming")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl.find_unique_near_pam()
    tl.check_restriction_enzymes([])
    tl.create_index(configpath=configpath)
    tl.launch_control_search(genome_fasta, configpath=configpath,
                             length=20, n=6, seed=1)
    with caplog.at_level(_logging.WARNING, logger="guidemaker_tpu.targets"):
        cmin, cmed, df = tl.get_control_seqs(
            parse_fasta(genome_fasta), configpath=configpath,
            length=20, n=6, seed=2)   # different seed -> recompute
    assert len(df) == 6


def test_neighbors_dict_padded_k_gt_db(genome_fasta, configpath):
    """knum > database size pads (-1) entries; the dict view must
    truncate them (reference neighbor-dict shape)."""
    tl = TargetProcessor(targets=_fixture_targets(), lsr=10, editdist=2,
                         knum=5)
    tl.check_restriction_enzymes([])
    tl.find_unique_near_pam()
    tl.create_index(configpath=configpath)
    tl.get_neighbors(configpath=configpath)
    nb = tl.neighbors
    for seq, entry in nb.items():
        assert len(entry["neighbors"]["dist"]) <= 2
        assert len(entry["neighbors"]["seqs"]) == \
            len(entry["neighbors"]["dist"])


def test_phase2_prewarm_thread_runs(genome_fasta, configpath, monkeypatch):
    """The phase-2 prewarm gate opens for genome-scale indexes; force it
    open on the tiny fixture and require a clean join."""
    pamobj = PamTarget("ATGA", "5prime", "hamming")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl.find_unique_near_pam()
    tl.check_restriction_enzymes([])
    tl.create_index(configpath=configpath)
    from guidemaker_tpu.knn.driver import KnnIndex
    monkeypatch.setattr(KnnIndex, "__len__", lambda self: 9000)
    t = tl._launch_phase2_prewarm()
    assert t is not None
    t.join(timeout=300)
    assert not t.is_alive()


def test_prewarm_controls_threads_join(genome_fasta, configpath):
    pamobj = PamTarget("ATGA", "5prime", "hamming")
    targets = pamobj.find_targets(parse_fasta(genome_fasta), target_len=20)
    tl = TargetProcessor(targets=targets, lsr=10, editdist=2, knum=2)
    tl.find_unique_near_pam()
    tl.check_restriction_enzymes([])
    tl.create_index(configpath=configpath)
    t = tl.prewarm_controls(configpath, 20, 8)
    t.join(timeout=300)
    tl._prewarm_thread2.join(timeout=300)
    assert not t.is_alive() and not tl._prewarm_thread2.is_alive()
