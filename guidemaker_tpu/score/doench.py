"""Doench 2016 on-target efficiency scoring (TreeEnsemble in JAX).

Replaces the reference's onnxruntime session (doench_predict.py:83-131) with
a batched vectorized descent over the gradient-boosted trees extracted from
the same model format: at each level every (sequence, tree) pair advances
one step via fancy-indexed gathers.

The descent runs on the HOST in numpy: the bundled model is 100 trees x
15 nodes (~24 KB of tables) and evaluation is gather-bound, with no
matrix work for a device to speed up.  Exactness is unchanged: the
float32 threshold comparisons and sequential float32 tree-order
accumulation are identical operations in numpy and XLA.

Bit-compatibility: thresholds are compared in float32 against the float32
cast of the float64 feature matrix, and per-tree leaf weights are summed
sequentially in float32 in tree order — matching onnxruntime's accumulation
(validated against the reference's golden scores,
``/root/reference/tests/test_core.py:259-263``).
"""
from __future__ import annotations

import json
import logging
import os
from typing import Optional

import numpy as np

from ..definitions import DATA_DIR
from .doench_features import featurize
from .onnx_tree import TreeEnsemble, parse_tree_ensemble

logger = logging.getLogger(__name__)

MODEL = os.path.join(DATA_DIR, "doench_v3_trees.npz")
MODEL_META = os.path.join(DATA_DIR, "doench_v3_options.json")

_ENSEMBLE_CACHE = {}


def load_ensemble(model_file: Optional[str] = None) -> TreeEnsemble:
    """Load a tree ensemble from our .npz or directly from a .onnx file."""
    path = model_file or MODEL
    if path not in _ENSEMBLE_CACHE:
        if path.endswith(".onnx"):
            ens = TreeEnsemble.from_attrs(parse_tree_ensemble(path))
        else:
            ens = TreeEnsemble.load_npz(path)
        _ENSEMBLE_CACHE[path] = ens
    return _ENSEMBLE_CACHE[path]


def _descend_trees(xf: np.ndarray, ens: "TreeEnsemble") -> np.ndarray:
    """Per-(sequence, tree) leaf node id, vectorized numpy descent.

    xf: (B, F) float32, Fortran-ordered (columns contiguous).  Returns
    (B, T) intp node ids.  Descends tree-by-tree: per (tree, level) the
    work is one contiguous column read + a scalar-threshold compare +
    small-table gathers, which is far more cache-friendly than a
    (B, T)-wide level-synchronous descent.  Comparisons are float32
    ``xv <= thr`` — bit-identical to onnxruntime's branch rule
    (BRANCH_LEQ) and to an XLA evaluation of the same arrays.
    """
    n_trees = ens.feature.shape[0]
    out = np.empty((xf.shape[0], n_trees), dtype=np.intp)
    for t in range(n_trees):
        feature, threshold = ens.feature[t], ens.threshold[t]
        left, right = ens.children[t, :, 0], ens.children[t, :, 1]
        is_leaf = ens.is_leaf[t]
        node = np.zeros(xf.shape[0], dtype=np.intp)
        for _ in range(int(ens.max_depth)):
            leaf = is_leaf[node]
            if leaf.all():
                break
            feat = feature[node]
            xv = np.take_along_axis(xf, feat[:, None], axis=1)[:, 0]
            nxt = np.where(xv <= threshold[node], left[node], right[node])
            node = np.where(leaf, node, nxt)
        out[:, t] = node
    return out


#: batch tile bounding the descent's (B, T) temporaries (~6 arrays)
BATCH_TILE = 262144


def ensemble_predict(ens: TreeEnsemble, features: np.ndarray,
                     int_col: Optional[np.ndarray] = None) -> np.ndarray:
    """Evaluate the ensemble; returns (B, 1) float32 like onnxruntime.

    ``int_col`` is accepted for API stability and unused (it marked
    uint8-representable columns for the retired device-transfer path).
    """
    xf = np.asfortranarray(features, dtype=np.float32)
    n = xf.shape[0]
    if n == 0:
        return np.zeros((0, 1), dtype=np.float32)
    n_trees = ens.feature.shape[0]
    nodes = np.concatenate(
        [_descend_trees(xf[lo:lo + BATCH_TILE], ens)
         for lo in range(0, n, BATCH_TILE)], axis=0)         # (B, T)
    w = ens.value[np.arange(n_trees)[None, :], nodes]        # (B, T) f32
    # sequential float32 accumulation in tree order (onnxruntime-compatible)
    score = np.zeros(n, dtype=np.float32)
    for t in range(n_trees):
        score += w[:, t]
    score += np.float32(ens.base_value)
    return score[:, None]


def predict(seq: np.ndarray, model_file: Optional[str] = None,
            model_metadata: Optional[str] = None, pam_audit: bool = True,
            length_audit: bool = False, num_threads: int = 1) -> np.ndarray:
    """Predict Doench-2016 regression scores for 30-mer sequences.

    Signature-compatible with the reference's ``doench_predict.predict``
    (doench_predict.py:83-131).  ``model_file`` may be our ``.npz`` or an
    skl2onnx ``.onnx`` TreeEnsembleRegressor.  ``num_threads`` is accepted
    for compatibility (featurization is vectorized, no process pool).
    """
    if not isinstance(seq, np.ndarray):
        raise AssertionError("Please ensure seq is a numpy array")
    if len(seq) == 0 or len(seq[0]) <= 0:
        raise AssertionError("Make sure that seq is not empty")
    if not isinstance(seq[0], str):
        raise AssertionError(
            "Please ensure input sequences are in string format, i.e. 'AGAG' "
            "rather than ['A' 'G' 'A' 'G'] or alternate representations")
    if model_metadata is not None:
        with open(model_metadata) as f:
            json.load(f)  # accepted for API parity; all feature sets are built
    from ..util import substage_timer
    ens = load_ensemble(model_file)
    with substage_timer("doench: featurize"):
        feats = featurize(list(seq), pam_audit=pam_audit)
    from .doench_features import INT_FEATURE_MASK
    with substage_timer("doench: tree descent"):
        return ensemble_predict(ens, feats, int_col=INT_FEATURE_MASK)


def predict_codes(codes: np.ndarray, pam_audit: bool = True) -> np.ndarray:
    """:func:`predict` on a pre-encoded (n, 30) uint8 code matrix — the
    pipeline's string-free route (codes come off the Arrow buffer)."""
    from ..util import substage_timer
    from .doench_features import INT_FEATURE_MASK, featurize_codes
    ens = load_ensemble()
    with substage_timer("doench: featurize"):
        feats = featurize_codes(codes, pam_audit=pam_audit)
    with substage_timer("doench: tree descent"):
        return ensemble_predict(ens, feats, int_col=INT_FEATURE_MASK)


def get_doench_efficiency_score(df, pam_orientation, num_threads=1):
    """Append the ``Efficiency`` column (reference core.py:1152-1166).

    Replicates the reference's gating quirks verbatim: requires 3prime PAM
    orientation and the PAM set to equal exactly {AGG, CGG, TGG, GGG}; drops
    guides with N in the 30-mer context before scoring.
    """
    checkset = {"AGG", "CGG", "TGG", "GGG"}
    df2 = df[-df.target_seq30.str.contains("N")]
    if len(df) != len(df2):
        logger.warning(
            "%d guides were removed from consideration because there were N's "
            "in the region flanking the PAM site. These cannot be scored.",
            len(df) - len(df2))
    if pam_orientation == "3prime" and set(df2.PAM) == checkset:
        # string-free: upper-case via the Arrow kernel, codes straight
        # off the buffer — no 100k-entry Python string array
        from .. import dna
        codes, _ = dna.encode_pandas(df2.target_seq30.str.upper())
        doenchscore = predict_codes(codes)
        df2["Efficiency"] = doenchscore.ravel()
    else:
        logger.warning(
            "NOTE: doench_efficiency_score based on Doench et al. 2016 - can "
            "only be used for NGG PAM). Check PAM sequence and PAM orientation")
        df2["Efficiency"] = "Not Available"
    return df2.drop("target_seq30", axis=1)
