"""Mesh sharding rules, activation layouts, the compressed pod sync and
the pipeline schedule (the port of ``repro.distributed``), for one card:
every mesh axis has size 1, and a request for more devices raises."""
