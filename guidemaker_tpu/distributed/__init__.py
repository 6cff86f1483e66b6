"""Multi-host / multi-chip runtime setup.

The reference is strictly single-process (SURVEY.md §5).  Here the scale
path is: ``init_distributed()`` on every host -> build a mesh over the
global device set -> the sharded k-NN driver (knn/sharded.py) runs
unchanged, with database shards resident per-device and the count and
top-k merges as collectives (NVLink within a GPU host, the network
across hosts).
"""
from .mesh import init_distributed, auto_mesh, device_summary

__all__ = ["init_distributed", "auto_mesh", "device_summary"]
