"""GuideMaker-TPU: CRISPR guide-RNA pool design on an accelerator.

A from-scratch JAX framework with the capabilities of GuideMaker
(USDA-ARS-GBRU): genome-wide gRNA design for non-model genomes and custom
CRISPR-Cas systems.  The computational core — genome-wide off-target k-NN —
runs as exact (not approximate) nearest-neighbor search: tensor-core
matrix products via JAX/XLA and Pallas GPU kernels, sharded over device
meshes for large genomes.

Public API mirrors the reference package so users can switch with
minimal changes:

* :class:`PamTarget` — PAM/target enumeration (vectorized motif scan)
* :class:`TargetProcessor` — guide filtering + exact off-target k-NN
* :class:`Annotation` — feature ingestion + nearest-feature join
* :func:`get_fastas`, :func:`extend_ambiguous_dna`
* :func:`cfd_score`, :func:`get_doench_efficiency_score`
* :mod:`guidemaker_tpu.cli` — command line with the reference's flags
"""

import os as _os


def _configure_compile_cache():
    """Persistent XLA compilation cache; returns its directory, or None
    when the cache stays off.

    ``JAX_COMPILATION_CACHE_DIR`` (or a directory already set in JAX's
    config) wins and no other is set; otherwise the cache lives at the
    fixed path ``<checkout>/.jax_cache``, so every run of this checkout
    finds what an earlier one compiled.  Runs pinned to the CPU keep it
    off: XLA:CPU entries are compiled for the writing host's features
    and do not load reliably on another.
    """
    import jax
    platforms = (jax.config.jax_platforms
                 or _os.environ.get("JAX_PLATFORMS") or "").strip().lower()
    if platforms == "cpu":
        return None
    cache_dir = (_os.environ.get("JAX_COMPILATION_CACHE_DIR")
                 or jax.config.jax_compilation_cache_dir)
    if not cache_dir:
        cache_dir = _os.path.join(
            _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
            ".jax_cache")
        jax.config.update("jax_compilation_cache_dir", cache_dir)
    # cache every program: a cold run compiles dozens of small ones
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return cache_dir


COMPILE_CACHE_DIR = _configure_compile_cache()

from .definitions import ROOT_DIR, CONFIG_PATH, WEB_APP, APP_PARAMETER_IMG, APP_EXPERIMENT_FILE
from .dna import extend_ambiguous_dna, reverse_complement
from .io import get_fastas, is_gzip
from .scan import PamTarget
from .targets import TargetProcessor
from .annotate import Annotation
from .score import cfd_score, get_doench_efficiency_score
from .plot import GuideMakerPlot
from . import doench_predict
from . import cfd_score_calculator
from . import doench_featurization

# single source of truth for the package version: pyproject.toml reads
# this attribute dynamically ([tool.setuptools.dynamic])
__version__ = "0.5.0"

__all__ = [
    "PamTarget", "TargetProcessor", "Annotation",
    "get_fastas", "is_gzip", "extend_ambiguous_dna", "reverse_complement",
    "cfd_score", "get_doench_efficiency_score", "GuideMakerPlot",
    "doench_predict", "cfd_score_calculator", "doench_featurization",
    "ROOT_DIR", "CONFIG_PATH", "WEB_APP",
]

# `guidemaker_tpu.core` namespace mirrors `guidemaker.core` for drop-in use.
from . import core  # noqa: E402
