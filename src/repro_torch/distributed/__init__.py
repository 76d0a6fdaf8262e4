"""Sharding rules, collectives and pipeline parallelism over the port's
meshes (mirror of ``repro.distributed``)."""
