"""Spatial decomposition (port of lammps_plugins_tpu/parallel/)."""

from .per_device import PerDeviceEngine
from .sharded_engine import HaloTables, ShardedEngine, ShardState

__all__ = ["HaloTables", "PerDeviceEngine", "ShardedEngine", "ShardState"]
