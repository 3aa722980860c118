"""Fault tolerance of the port (``fault``): the seeded chaos injector that
storms the serving seams, the restart loop, deterministic shard
reassignment and heartbeat membership."""
