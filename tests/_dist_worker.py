"""Worker process for the 2-process jax.distributed proof
(tests/test_distributed.py::test_two_process_distributed).

Each process owns ``ndev`` virtual CPU devices; the database shards over
all 2*ndev global devices, so the all_gather top-k merge and the psum
count reduction both cross the process boundary — the path of a
multi-host deployment, exercised on CPU.
"""
import os
import sys

PID = int(sys.argv[1])
PORT = sys.argv[2]
NDEV = int(sys.argv[3])

os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + f" --xla_force_host_platform_device_count={NDEV}")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from guidemaker_tpu.distributed import init_distributed  # noqa: E402

init_distributed(coordinator_address=f"127.0.0.1:{PORT}",
                 num_processes=2, process_id=PID)
assert jax.process_count() == 2, jax.process_count()
assert len(jax.devices()) == 2 * NDEV, len(jax.devices())
assert len(jax.local_devices()) == NDEV

import numpy as np  # noqa: E402

from guidemaker_tpu import dna  # noqa: E402
from guidemaker_tpu.knn.hamming import unpack_keys  # noqa: E402
from guidemaker_tpu.knn.sharded import (_put_global, count_step,  # noqa: E402
                                        make_mesh, shard_features,
                                        topk_step)
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

rng = np.random.default_rng(5)
codes = rng.integers(0, 4, size=(512, 20)).astype(np.uint8)
codes[3] = codes[4]
codes[4, 0] ^= 1                       # a close pair for the counter
oh = dna.one_hot_matrix(codes).astype(np.int8)
NQ, ND, K, L = 64, 512, 3, 20

d_shards = 2 * NDEV                    # per-host db shards, cross-host merge
mesh = make_mesh(1, d_shards)
sdb = shard_features(oh, mesh, length=L)
q_sh = _put_global(oh[:NQ], NamedSharding(mesh, P("q", None)))

step = topk_step(mesh, k=K, length=L, engine="xla")
keys = step(q_sh, sdb.feats, sdb.offsets)
# q axis has one shard -> the result is replicated on every device and
# therefore fully addressable in both processes
got_d, got_i = unpack_keys(np.asarray(jax.device_get(keys))[:NQ])

# single-process oracle, computed identically on both hosts
dm = (codes[:NQ, None, :] != codes[None, :, :]).sum(2)
keys_np = dm.astype(np.int64) * (1 << 24) + np.arange(ND)[None, :]
order = np.sort(keys_np, axis=1)[:, :K]
np.testing.assert_array_equal(got_d, (order >> 24).astype(np.int32))
np.testing.assert_array_equal(got_i, (order & ((1 << 24) - 1)).astype(np.int32))

cstep = count_step(mesh, editdist=2, length=L, engine="xla")
counts = np.asarray(jax.device_get(cstep(q_sh, sdb.feats)))[:NQ]
np.testing.assert_array_equal(counts, (dm < 2).sum(axis=1))

print(f"DIST OK pid={PID} devices={len(jax.devices())} "
      f"processes={jax.process_count()}", flush=True)
