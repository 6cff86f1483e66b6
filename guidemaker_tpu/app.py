"""Streamlit web app for GuideMaker-TPU.

Feature parity with the reference's bundled app
(``/root/reference/guidemaker/data/app.py:166-365``): multi-file GenBank
upload, FASTA + GFF/GTF upload, bundled demo genomes, a restriction-enzyme
tags widget, all design parameters, in-app per-accession result charts
(Vega-Lite, rendered natively by Streamlit — no Altair dependency),
download links, the parameter dictionary and the pooled-CRISPR experiment
protocol page, and session cleanup.

Run with:  streamlit run guidemaker_tpu/app.py
(Streamlit is an optional dependency; the core package never imports this
module.  ``main(st)`` accepts an injected streamlit-compatible module so
the app logic is smoke-testable headless.)
"""
from __future__ import annotations

import base64
import os
import shutil
import subprocess
import sys
import uuid
from typing import List, Optional

import pandas as pd

from . import definitions

DEMO_GENOMES = ["Carsonella_ruddii.gbk.gz", "Pseudomonas_aeruginosa.gbk.gz"]


def build_cli_args(*, workdir: str, logfile: str, genbank: List[str] = (),
                   fasta: List[str] = (), gff: List[str] = (),
                   pam: str = "NGG", pam_orientation: str = "3prime",
                   guidelength: int = 20, lsr: int = 10, dtype: str = "hamming",
                   dist: int = 2, before: int = 100, into: int = 200,
                   knum: int = 3, controls: int = 10,
                   restriction_enzymes: Optional[List[str]] = None,
                   scoring: bool = True, threads: int = 2) -> List[str]:
    """The CLI invocation the app runs (pure function; unit-testable)."""
    args = [sys.executable, "-m", "guidemaker_tpu.cli"]
    if genbank:
        args += ["--genbank"] + list(genbank)
    else:
        args += ["--fasta"] + list(fasta) + ["--gff"] + list(gff)
    args += ["--pamseq", pam,
             "--guidelength", str(guidelength),
             "--pam_orientation", pam_orientation,
             "--lsr", str(lsr), "--dtype", dtype, "--dist", str(dist),
             "--outdir", workdir, "--log", logfile,
             "--into", str(into), "--before", str(before),
             "--knum", str(knum), "--controls", str(int(controls)),
             "--threads", str(threads), "--plot"]
    if scoring:
        args += ["--cfd_score", "--doench_efficiency_score"]
    if restriction_enzymes:
        args += ["--restriction_enzyme_list"] + list(restriction_enzymes)
    return args


def run_command(st, args):
    """Run the CLI and surface status (reference app.py:93-104)."""
    st.info(f"Running:: '{' '.join(args)}'")
    env = dict(os.environ)
    pkg_parent = os.path.dirname(definitions.ROOT_DIR)
    env["PYTHONPATH"] = pkg_parent + os.pathsep + env.get("PYTHONPATH", "")
    result = subprocess.run(args, capture_output=True, text=True, env=env)
    if result.returncode != 0:
        st.error(result.stderr[-4000:])
    else:
        st.info("GuideMaker-TPU run complete")
    return result.returncode


def download_link(path: str, label: str) -> str:
    """Binary file downloader as an HTML anchor (reference app.py:107-113)."""
    with open(path, "rb") as f:
        b64 = base64.b64encode(f.read()).decode()
    name = os.path.basename(path)
    return (f'<a href="data:application/octet-stream;base64,{b64}" '
            f'download="{name}">{label}</a>')


def _tags_widget(st, label: str, default: List[str]) -> List[str]:
    """Restriction-enzyme tags input: streamlit_tags when installed
    (reference app.py:209), else a space-separated text input."""
    try:
        from streamlit_tags import st_tags_sidebar
        return st_tags_sidebar(label=label, text="Enter to add more",
                               value=default)
    except ImportError:
        raw = st.sidebar.text_input(label + " (space separated)",
                                    value=" ".join(default))
        return raw.split()


def render_results(st, workdir: str, logfile: str) -> None:
    """Per-accession interactive charts + download links
    (reference app.py:303-341)."""
    targets_path = os.path.join(workdir, "targets.csv.gz")
    if not os.path.exists(targets_path):
        return
    from .plot import _single_spec
    source = pd.read_csv(targets_path, low_memory=False)
    for accession in sorted(set(source["Accession"])):
        st.markdown(f"**Accession:** {accession}")
        st.vega_lite_chart(None, _single_spec(
            source[source["Accession"] == accession]))
    st.subheader(f"Guide RNAs ({len(source)})")
    st.dataframe(source.head(500))
    st.markdown(download_link(targets_path, "✅ Download targets.csv.gz"),
                unsafe_allow_html=True)
    controls_path = os.path.join(workdir, "controls.csv.gz")
    if os.path.exists(controls_path):
        ctrl = pd.read_csv(controls_path)
        st.subheader(f"Control RNAs ({len(ctrl)})")
        st.dataframe(ctrl.head(100))
        st.markdown(download_link(controls_path,
                                  "✅ Download controls.csv.gz"),
                    unsafe_allow_html=True)
    if os.path.exists(logfile):
        st.markdown(download_link(logfile, "✅ Log File"),
                    unsafe_allow_html=True)


def main(st=None):
    """Run the web app (``st`` injectable for headless smoke tests)."""
    if st is None:  # pragma: no cover - interactive path
        try:
            import streamlit as st
        except ImportError as e:
            raise SystemExit(
                "The web app requires streamlit (`pip install streamlit`); "
                "the core guidemaker-tpu CLI and library do not.") from e

    st.markdown('<strong style="font-size:36px;color:#0021A5">'
                'GuideMaker-TPU</strong>', unsafe_allow_html=True)
    st.markdown('<strong style="font-size:18px;color:#FA4616">Design '
                'CRISPR-Cas guide RNA pools in non-model genomes \U0001F9A0 '
                '\U0001F9EC — exact genome-wide off-target search'
                '</strong>', unsafe_allow_html=True)
    st.markdown("---")

    session_id = str(uuid.uuid4())
    workdir = os.path.join(".streamlit_runs", session_id)
    os.makedirs(workdir, exist_ok=True)
    logfile = os.path.join(workdir, "guidemaker.log")

    # --- inputs (reference app.py:191-227) ---
    gbk_files = st.sidebar.file_uploader(
        "Upload one or more genome files [.gbk, .gbk.gz]",
        type=[".gbk", ".gb", ".gz", ".gbff"], accept_multiple_files=True)
    fasta_files = st.sidebar.file_uploader(
        "Upload one or more FASTA files [.fasta, .fasta.gz]",
        type=[".fasta", ".fna", ".fa", ".gz"], accept_multiple_files=True)
    gff_files = st.sidebar.file_uploader(
        "Upload GFF/GTF file(s) if you are using FASTA [.gff, .gtf]",
        type=[".gff", ".gff3", ".gtf", ".gz"], accept_multiple_files=True)
    demo = st.sidebar.selectbox("OR use a demo genome", DEMO_GENOMES)

    pam = st.sidebar.text_input("Input PAM motif [e.g. NGG]", "NGG")
    restriction = _tags_widget(st, "Restriction enzymes [e.g. NGRT]:",
                               ["NGRT"])
    pam_orientation = st.sidebar.selectbox(
        "PAM orientation [3prime, 5prime]", ("3prime", "5prime"))
    guidelength = st.sidebar.number_input("Guide length [10-27]", 10, 27,
                                          value=20)
    lsr = st.sidebar.number_input("Length of seed region [0-27]", 0, 27,
                                  value=10)
    dtype = st.sidebar.selectbox("Distance type [hamming, leven]",
                                 ("hamming", "leven"))
    dist = st.sidebar.number_input("Edit distance [0-5]", 0, 5, value=2)
    before = st.sidebar.number_input("Before [1-500]", 1, 500, value=100,
                                     step=50)
    into = st.sidebar.number_input("Into [1-500]", 1, 500, value=200,
                                   step=50)
    knum = st.sidebar.number_input("Similar guides [2-20]", 2, 20, value=3)
    controls = st.sidebar.number_input("Control RNAs", 1, 100000, value=10,
                                       step=100)
    scoring = st.sidebar.checkbox(
        "Doench efficiency + CFD scores (NGG 3prime only)", value=True)

    # --- stage the chosen inputs ---
    def _save(uploaded, name):
        path = os.path.join(workdir, name)
        with open(path, "wb") as f:
            f.write(uploaded.getbuffer() if hasattr(uploaded, "getbuffer")
                    else uploaded)
        return path

    genbank_paths, fasta_paths, gff_paths = [], [], []
    if gbk_files:
        genbank_paths = [_save(u, f"input_{i}.gbk{'.gz' if u.name.endswith('.gz') else ''}")
                         for i, u in enumerate(gbk_files)]
    elif fasta_files and gff_files:
        fasta_paths = [_save(u, f"input_{i}.fasta{'.gz' if u.name.endswith('.gz') else ''}")
                       for i, u in enumerate(fasta_files)]
        gff_paths = [_save(u, f"input_{i}.gff{'.gz' if u.name.endswith('.gz') else ''}")
                     for i, u in enumerate(gff_files)]
    else:
        genbank_paths = [os.path.join(definitions.DATA_DIR, demo)]

    args = build_cli_args(
        workdir=workdir, logfile=logfile, genbank=genbank_paths,
        fasta=fasta_paths, gff=gff_paths, pam=pam,
        pam_orientation=pam_orientation, guidelength=int(guidelength),
        lsr=int(lsr), dtype=dtype, dist=int(dist), before=int(before),
        into=int(into), knum=int(knum), controls=int(controls),
        restriction_enzymes=restriction, scoring=bool(scoring))

    if st.sidebar.button("SUBMIT"):
        if run_command(st, args) == 0:
            render_results(st, workdir, logfile)

    # --- parameter dictionary + protocol page (reference app.py:343-351) ---
    with st.expander("Parameter Dictionary"):
        with open(definitions.APP_PARAMETER_FILE) as fh:
            st.markdown(fh.read())
    with st.expander("Designing Experiments with GuideMaker Results"):
        with open(definitions.APP_EXPERIMENT_FILE) as fh:
            st.markdown(fh.read(), unsafe_allow_html=True)
    st.markdown(
        "##### License ©️\n\n*GuideMaker-TPU reimplements the "
        "USDA-ARS GuideMaker workflow (CC0 1.0) as a JAX framework.*")

    if st.button("Clean up session files"):
        shutil.rmtree(workdir, ignore_errors=True)


if __name__ == "__main__":
    main()
