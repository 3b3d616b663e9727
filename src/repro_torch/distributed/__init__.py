"""Sharded spectral inference: a ``core.plan.ShardedNetworkPlan`` run
over the devices of a ``launch.mesh.SpectralMesh``."""
