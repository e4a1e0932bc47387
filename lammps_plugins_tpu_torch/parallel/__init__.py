"""Spatial decomposition (port of lammps_plugins_tpu/parallel/)."""

from .sharded_engine import HaloTables, ShardedEngine, ShardState

__all__ = ["HaloTables", "ShardedEngine", "ShardState"]
