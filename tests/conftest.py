"""Test configuration.

The suite runs on the JAX CPU backend with 8 virtual devices (multi-device
sharding tests use ``--xla_force_host_platform_device_count``); this must
happen before the first ``jax`` backend initialization.  A process that
names the GPU (``JAX_PLATFORMS=cuda``) keeps it: the ``gpu``-marked tests
(``tests/test_gpu_hw.py``) then run the kernels compiled for the card.
Each of those tests decides in its ``gpu`` fixture whether a card is
present, and skips otherwise.
"""
import functools
import os

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_force_host_platform_device_count=8")

import jax  # noqa: E402

if os.environ.get("JAX_PLATFORMS", "").strip().lower() not in ("cuda", "gpu"):
    jax.config.update("jax_platforms", "cpu")

import pytest  # noqa: E402

# first-party coverage (no third-party tools in this environment):
# GUIDEMAKER_COV=1 pytest tests/ -q  -> per-file table + coverage_guidemaker.json
if os.environ.get("GUIDEMAKER_COV") == "1":
    import sys as _sys
    _sys.path.insert(0, os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"))
    import cov as _cov

    _cov.start()

    def pytest_sessionfinish(session, exitstatus):
        _cov.report()

TEST_DIR = os.path.dirname(os.path.abspath(__file__))
TEST_DATA = os.path.join(TEST_DIR, "test_data")


@pytest.fixture
def gpu():
    """Skip unless the default JAX device is a GPU."""
    if jax.devices()[0].platform != "gpu":
        pytest.skip("needs a GPU (run with JAX_PLATFORMS=cuda on a GPU host)")


@pytest.fixture
def interpret_kernels(monkeypatch):
    """Run the Pallas GPU kernels in interpret mode, so the driver's
    GPU-backend paths run on the CPU."""
    from guidemaker_tpu.knn import pallas_gpu as pg
    monkeypatch.setattr(pg, "count_within",
                        functools.partial(pg.count_within, interpret=True))
    monkeypatch.setattr(pg, "topk_keys",
                        functools.partial(pg.topk_keys, interpret=True))


@pytest.fixture(scope="session")
def genome_fasta():
    return os.path.join(TEST_DATA, "Carsonella_ruddii.fasta.gz")


@pytest.fixture(scope="session")
def genome_gbk():
    return os.path.join(TEST_DATA, "Carsonella_ruddii.gbk.gz")


@pytest.fixture(scope="session")
def configpath():
    from guidemaker_tpu.definitions import CONFIG_PATH
    return CONFIG_PATH
