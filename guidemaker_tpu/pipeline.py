"""End-to-end guide-design pipeline (library API).

The orchestration mirrors the reference CLI flow
(``/root/reference/guidemaker/cli.py:123-273``) but is exposed as a callable
library function returning DataFrames, with the CLI as a thin wrapper.
pandas only appears at the edges; the hot path (scan, k-NN, scoring) runs on
numpy arrays and JAX devices.
"""
from __future__ import annotations

import logging
import os
import shutil
import tempfile
from dataclasses import dataclass, field
from typing import List, Optional

import pandas as pd

from . import definitions
from .util import maybe_profile, stage_timer
from .annotate import Annotation
from .io import get_fastas, parse_fasta
from .scan import PamTarget
from .score import cfd_score, get_doench_efficiency_score
from .targets import TargetProcessor

logger = logging.getLogger(__name__)


@dataclass
class PipelineConfig:
    """All knobs of a guide-design run (defaults = reference CLI defaults)."""
    genbank: Optional[List[str]] = None
    fasta: Optional[List[str]] = None
    gff: Optional[List[str]] = None
    pamseq: str = "NGG"
    pam_orientation: str = "3prime"
    guidelength: int = 20
    lsr: int = 10
    dtype: str = "hamming"
    dist: int = 2
    before: int = 100
    into: int = 200
    knum: int = 5
    controls: int = 1000
    threads: int = 2
    restriction_enzyme_list: List[str] = field(default_factory=list)
    feature_types: Optional[List[str]] = None
    attribute_key: str = "ID"
    filter_by_attribute: List[str] = field(default_factory=list)
    doench_efficiency_score: bool = False
    cfd_score: bool = False
    raw_output_only: bool = False
    plot: bool = False
    keeptemp: bool = False
    profile: Optional[str] = None   # JAX profiler trace directory
    seed: Optional[int] = None      # control-sampling seed (None=unseeded)
    tempdir: Optional[str] = None
    outdir: str = "."
    config: str = definitions.CONFIG_PATH

    def validate(self) -> None:
        """Reference parser validation (cli.py:80-89)."""
        assert self.lsr <= self.guidelength, (
            "The length of sequence near the PAM .i.e seed sequence that must "
            "be less than the guide length")
        assert 1 < len(self.pamseq) < 9, \
            "The length of the PAM sequence must be between 2-8"
        assert ((self.genbank is not None and self.fasta is None and self.gff is None)
                or (self.genbank is None and self.fasta is not None and self.gff is not None)
                or ((self.genbank is not None or self.fasta is not None)
                    and self.raw_output_only)), (
            "Please provide either Genbank files or Fasta and GFF files. If "
            "raw_output_only is selected Genbank or Fasta files are required.")


@dataclass
class PipelineResult:
    targets: Optional[pd.DataFrame] = None       # final pretty table
    raw_bed: Optional[pd.DataFrame] = None       # seed-unique guides (bed)
    controls: Optional[pd.DataFrame] = None
    control_min_dist: Optional[float] = None
    control_median_dist: Optional[float] = None
    processor: Optional[TargetProcessor] = None
    annotation: Optional[Annotation] = None


def run_pipeline(cfg: PipelineConfig, write_outputs: bool = True) -> PipelineResult:
    """Run the full GuideMaker workflow; optionally write csv.gz outputs."""
    cfg.validate()
    result = PipelineResult()
    owns_tempdir = False
    if cfg.tempdir and not os.path.exists(cfg.tempdir):
        logger.warning("Specified tempdir %s does not exist; creating it",
                       cfg.tempdir)
        os.makedirs(cfg.tempdir)
        tempdir = cfg.tempdir
    elif cfg.tempdir:
        tempdir = cfg.tempdir
    else:
        tempdir = tempfile.mkdtemp(prefix="guidemaker_")
        owns_tempdir = True
    try:
        with stage_timer("fasta conversion"):
            if cfg.genbank:
                logger.info("Writing fasta file from genbank file(s)")
                fastapath = get_fastas(cfg.genbank, input_format="genbank",
                                       tempdir=tempdir)
            else:
                fastapath = get_fastas(cfg.fasta, input_format="fasta",
                                       tempdir=tempdir)

        logger.info("Identifying PAM sites in the genome")
        pamobj = PamTarget(cfg.pamseq, cfg.pam_orientation, cfg.dtype)
        with stage_timer("pam scan"):
            pamtargets = pamobj.find_targets(
                seq_record_iter=parse_fasta(fastapath),
                target_len=cfg.guidelength)
        tl = TargetProcessor(targets=pamtargets, lsr=cfg.lsr,
                             editdist=cfg.dist, knum=cfg.knum)
        result.processor = tl
        n_targets = len(tl)
        logger.info("Total PAM sites considered: %d", n_targets)

        logger.info("Checking guides for restriction enzymes")
        tl.check_restriction_enzymes(
            restriction_enzyme_list=cfg.restriction_enzyme_list)
        logger.info("Identifying guides that are unique near the PAM site")
        tl.find_unique_near_pam()
        logger.info("Number of guides with non unique seed sequence: %d",
                    int(tl.targets.isseedduplicated.sum()))

        logger.info("Indexing all potential guide sites (exact k-NN)")
        with stage_timer("index build"):
            tl.create_index(configpath=cfg.config, num_threads=cfg.threads)
        if cfg.controls > 0 and not cfg.raw_output_only:
            # compile the control-ladder device programs (sampler, chunk
            # counting, passer gather, exact k=1) in a daemon thread NOW:
            # on a cold cache they cost ~8-10 s, which otherwise lands in
            # the controls tail after the search launches post-retention;
            # compiles are host-side and overlap the retention compiles
            # on other cores (the search itself still launches after the
            # retention join — overlapping their DEVICE work serialized
            # both, measured +7 s in round 4)
            tl.prewarm_controls(cfg.config, cfg.guidelength, cfg.controls)
        logger.info("Finding guides with distance > %s to all other guides",
                    cfg.dist)
        # The retention pass (exact k-NN counting) runs in a background
        # thread: nothing before _format_guide_table needs its result,
        # so its device time and (cold) compile overlap the host-bound
        # annotation stages below.  The "exact k-NN" stage records the
        # JOIN wait — the wall-clock the pass actually costs the
        # pipeline.  The JAX profiler window (--profile) spans launch
        # to join so the trace captures the retention device work.
        import threading
        import time as _time
        profile_cm = maybe_profile(cfg.profile)
        profile_cm.__enter__()
        profile_open = [True]
        nb_exc: List[BaseException] = []
        t_nb0 = _time.time()

        def _run_neighbors():
            try:
                tl.get_neighbors(configpath=cfg.config,
                                 num_threads=cfg.threads)
            except BaseException as exc:   # re-raised at the join
                nb_exc.append(exc)

        nb_t = threading.Thread(target=_run_neighbors, name="gm-retention",
                                daemon=True)
        nb_t.start()

        def _join_neighbors():
            with stage_timer("exact k-NN"):
                nb_t.join()
            if profile_open[0]:
                profile_open[0] = False
                profile_cm.__exit__(None, None, None)
            logger.debug("retention pass total %.2fs (incl. overlapped)",
                         _time.time() - t_nb0)
            if nb_exc:
                raise nb_exc[0]

        def _cleanup_neighbors():
            # exception path before the join: finalize the profiler trace
            # and surface (log) a retention failure that would otherwise
            # be masked by the in-flight exception
            if profile_open[0]:
                profile_open[0] = False
                try:
                    profile_cm.__exit__(None, None, None)
                except Exception:
                    pass
            if nb_exc:
                logger.error("background retention pass also failed: %r",
                             nb_exc[0])

        tf_df = tl.export_bed()
        result.raw_bed = tf_df

        if cfg.raw_output_only:
            _join_neighbors()
            if write_outputs:
                os.makedirs(cfg.outdir, exist_ok=True)
                out = os.path.join(cfg.outdir, "rawguides.csv.gz")
                tf_df.to_csv(out, index=False, header=[
                    "Chromosome", "Start", "Stop", "gRNA", "Strand"])
                logger.info("Raw guides written to %s", out)
            return result

        logger.info("Creating annotations")
        if cfg.genbank:
            anno = Annotation(annotation_list=cfg.genbank,
                              annotation_type="genbank", target_bed_df=tf_df)
        else:
            anno = Annotation(annotation_list=cfg.gff,
                              annotation_type="gff", target_bed_df=tf_df)
        result.annotation = anno
        from .util import substage_timer
        with stage_timer("annotation"):
            with substage_timer("anno: parse features"):
                anno.get_annotation_features(feature_types=cfg.feature_types)
            logger.info("Total number of %s in the input genome: %d",
                        *anno.locuslen())
            with substage_timer("anno: nearby join"):
                anno._get_nearby_features()
            with substage_timer("anno: filter clauses"):
                anno._filter_features(before_feat=cfg.before,
                                      after_feat=cfg.into)
            with substage_timer("anno: qualifiers"):
                anno._get_qualifiers(configpath=cfg.config)
        _join_neighbors()
        if cfg.controls > 0:
            # run the whole control search (mostly device time) in the
            # background, launched AFTER the retention join: the ladder's
            # triage rungs are near-roofline device programs, and
            # overlapping them with the retention counting just
            # serialized both (measured +7 s, round 4); the format/
            # scoring/write stages below are the window the ladder hides
            # in.  The controls stage at the end joins it.
            tl.launch_control_search(fastapath, configpath=cfg.config,
                                     length=cfg.guidelength,
                                     n=cfg.controls, seed=cfg.seed)
        with stage_timer("format table"):
            anno._format_guide_table(tl)
        prettydf = anno._filterlocus(cfg.attribute_key, cfg.filter_by_attribute)

        if cfg.doench_efficiency_score:
            logger.info("Scoring on-target efficiency (Doench et al. 2016)")
            # (vectorized; stage-timed)
            with stage_timer("doench scoring"):
                prettydf = get_doench_efficiency_score(
                    df=prettydf, pam_orientation=cfg.pam_orientation,
                    num_threads=cfg.threads)
        if cfg.cfd_score:
            logger.info("Scoring off-target activity (CFD)")
            with stage_timer("cfd scoring"):
                prettydf = cfd_score(df=prettydf)

        fd_zero = prettydf["Feature distance"].isin([0]).sum()
        logger.info("Guides within a gene (zero feature distance): %d", fd_zero)
        result.targets = prettydf

        write_thread = None
        write_exc: List[BaseException] = []
        if write_outputs:
            os.makedirs(cfg.outdir, exist_ok=True)

            def _write_targets():
                # format once via to_csv(index=False) (the golden-locked
                # byte stream), then gzip the blob in one pass —
                # measured ~1.6x faster than pandas' chunked gzip
                # writer.  compresslevel 1: ~3x faster than the zlib
                # default for ~15% larger output; content (and
                # pd.read_csv round-trip) is identical.
                try:
                    import gzip as _gzip
                    data = prettydf.to_csv(index=False)
                    with open(os.path.join(cfg.outdir, "targets.csv.gz"),
                              "wb") as raw:
                        with _gzip.GzipFile(fileobj=raw, mode="wb",
                                            compresslevel=1) as fh:
                            fh.write(data.encode())
                except BaseException as exc:
                    write_exc.append(exc)

            # the write overlaps the controls join below (host CPU vs
            # device wait); the "write targets.csv.gz" stage records the
            # join wait — the wall-clock the write actually costs
            write_thread = threading.Thread(target=_write_targets,
                                            name="gm-write", daemon=True)
            write_thread.start()

        if cfg.controls > 0:
            logger.info("Creating random control guides")
            with stage_timer("controls"):
                cmin, cmed, randomdf = tl.get_control_seqs(
                    parse_fasta(fastapath), configpath=cfg.config,
                    length=cfg.guidelength, n=cfg.controls,
                    num_threads=cfg.threads, seed=cfg.seed)
            result.controls = randomdf
            result.control_min_dist = cmin
            result.control_median_dist = cmed
            if write_outputs:
                randomdf.to_csv(os.path.join(cfg.outdir, "controls.csv.gz"))
            logger.info("Created %d controls; min dist %d, median %d",
                        cfg.controls, cmin, cmed)
            logger.info("Genome GC content: %.2f%%; size %.1f MB",
                        tl.gc_percent, tl.genomesize)

        if write_thread is not None:
            with stage_timer("write targets.csv.gz"):
                write_thread.join()
            if write_exc:
                raise write_exc[0]

        if cfg.plot and write_outputs:
            from .plot import GuideMakerPlot
            logger.info("Creating plots")
            GuideMakerPlot(prettydf=prettydf, outdir=cfg.outdir)

        logger.info("GuideMaker-TPU completed; results in %s", cfg.outdir)
        logger.info("Guide RNA candidates found: %d", len(prettydf))
        return result
    finally:
        cleanup = locals().get("_cleanup_neighbors")
        if cleanup is not None:
            cleanup()
        if owns_tempdir and not cfg.keeptemp:
            shutil.rmtree(tempdir, ignore_errors=True)
