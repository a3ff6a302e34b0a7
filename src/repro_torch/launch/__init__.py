"""Drivers of the port: ``ot_service`` (the serving, streaming and chaos
lanes). The JAX package's mesh helpers and LM drivers are not ported yet
(ROADMAP.md, queue A)."""
