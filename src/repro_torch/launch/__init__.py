"""Drivers of the port: ``ot_service`` (the serving, streaming and chaos
lanes), the LM drivers ``train`` and ``serve`` with their step factories
(``steps``) and input specs (``specs``), the mesh builders (``mesh``), and
the dry run (``dryrun``: every cell traced on fake tensors in a fake world)
with its counts and roofline (``analysis``, the counterpart of
``hlo_analysis`` and ``hlo_loops``). Counterpart of ``repro.launch``."""
