"""Synthetic LM data, packing and the prefetching pipeline (the port of
``repro.data``)."""
from repro_torch.data.packing import batch_packed, pack_documents  # noqa: F401
from repro_torch.data.pipeline import PrefetchIterator, \
    host_local_slice, to_device_batch  # noqa: F401
from repro_torch.data.synthetic import DataConfig, SyntheticLM  # noqa: F401
