"""Drivers of the port: ``ot_service`` (the serving, streaming and chaos
lanes) and the mesh builders (``mesh``). The JAX package's LM drivers are
not ported yet (ROADMAP.md, queue A)."""
