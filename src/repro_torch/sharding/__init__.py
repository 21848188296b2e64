"""Sharding of the port: the active mesh (``ctx``) and the layout rules
that map parameter, decode-state, batch and cohort trees to per-dim mesh
axes (``rules``), the counterpart of ``repro.sharding``."""
