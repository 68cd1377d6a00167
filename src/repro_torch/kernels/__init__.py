"""Hand-written CUDA kernels of the port, their plain PyTorch versions,
and the dispatch between them (``ops.py``).

Each wrapper also takes ``meta`` tensors (the dry run's,
``launch/dryrun.py``): it checks them and allocates its outputs and
scratch as on the card, records its operations and bytes
(``cost.py``) in place of the launch, and launches nothing."""
