"""Sharding rules, meshes and SPMD ranks (``sharding``, ``ranks``), the
counterpart of ``repro/parallel``."""
