"""Fault tolerance of the port: the seeded chaos injector that storms the
serving seams (``fault``)."""
