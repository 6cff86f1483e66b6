"""Distributed helpers tests (virtual 8-device CPU mesh)."""
import jax
import numpy as np
import pytest

from guidemaker_tpu import dna
from guidemaker_tpu.distributed import auto_mesh, device_summary, init_distributed
from guidemaker_tpu.knn.hamming import hamming_topk
from guidemaker_tpu.knn.sharded import sharded_hamming_topk


def test_init_distributed_single_process_noop():
    init_distributed()  # must not raise in single-process mode
    init_distributed()  # idempotent


def test_device_summary():
    s = device_summary()
    assert "device(s)" in s and "process(es)" in s


def test_two_process_distributed():
    """Real 2-process jax.distributed run (SURVEY §5): coordinator +
    worker subprocesses, database sharded across both hosts' devices,
    all_gather top-k merge and psum count crossing the process boundary
    (the multi-host path), byte-identical to the single-process oracle."""
    import os
    import socket
    import subprocess
    import sys

    with socket.socket() as s:          # pick a free coordinator port
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(__file__)
    worker = os.path.join(here, "_dist_worker.py")
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, worker, str(pid), str(port), "2"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in (0, 1)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=240)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("distributed worker timed out")
        outs.append((p.returncode, out, err))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{err[-3000:]}"
        assert "DIST OK" in out and "processes=2" in out


def test_auto_mesh_and_sharded_query():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = auto_mesh()
    assert mesh.devices.size == 8
    assert mesh.axis_names == ("q", "d")
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=(600, 20)).astype(np.uint8)
    oh = dna.one_hot_matrix(codes)
    d_sh, i_sh = sharded_hamming_topk(oh[:64], oh, 3, 20, mesh=mesh)
    d_1, i_1 = hamming_topk(oh[:64], oh, 3, 20)
    np.testing.assert_array_equal(d_sh, d_1)
    np.testing.assert_array_equal(i_sh, i_1)
