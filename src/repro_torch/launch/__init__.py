"""Drivers of the port: ``ot_service`` (the serving, streaming and chaos
lanes), the LM drivers ``train`` and ``serve`` with their step factories
(``steps``) and input specs (``specs``), and the mesh builders
(``mesh``). Counterpart of ``repro.launch``; the XLA tooling (``dryrun``,
``hlo_analysis``, ``hlo_loops``) waits (ROADMAP.md §A item 9)."""
