"""Small runtime utilities: stage timing and profiling hooks.

The reference has no tracing/profiling at all (SURVEY.md §5); here every
pipeline stage logs its wall time, and a run can be wrapped in a JAX
profiler trace (``--profile DIR`` on the CLI) for TensorBoard inspection
of device execution.
"""
from __future__ import annotations

import contextlib
import logging
import time

logger = logging.getLogger("guidemaker_tpu.timing")


@contextlib.contextmanager
def stage_timer(name: str):
    """Log the wall-clock (and process CPU) duration of a pipeline stage."""
    t0 = time.time()
    c0 = time.process_time()
    try:
        yield
    finally:
        logger.info("[stage] %-28s %8.3f s  (cpu %.3f s)",
                    name, time.time() - t0, time.process_time() - c0)


@contextlib.contextmanager
def substage_timer(name: str):
    """Like :func:`stage_timer` but tagged ``[sub]`` — fine-grained timings
    inside a stage, for profiling; bench.py's stage grabber matches the
    ``[stage]`` tag only, so sub-stages never pollute the artifact's
    stage table."""
    t0 = time.time()
    try:
        yield
    finally:
        logger.info("[sub] %-32s %8.3f s", name, time.time() - t0)


@contextlib.contextmanager
def maybe_profile(trace_dir: str = None):
    """Wrap a block in a JAX profiler trace when a directory is given."""
    if not trace_dir:
        yield
        return
    import jax
    with jax.profiler.trace(trace_dir):
        yield
    logger.info("JAX profiler trace written to %s", trace_dir)
