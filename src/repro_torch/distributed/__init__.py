"""Mesh sharding rules, activation layouts, collectives and the
compressed pod sync, and the pipeline schedule (the port of
``repro.distributed``), over one device or over the ranks of a mesh
(``distributed/launch.py``: one process a mesh device, ``gloo``)."""
