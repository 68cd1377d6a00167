"""The port's data modules against the JAX package: ``SyntheticLM``
batches bit for bit, document packing and batching, the prefetch
thread, the host slice and the device batch."""
import numpy as np
import pytest
import torch

from repro.data import DataConfig as JDataConfig, SyntheticLM as JSynthetic, \
    batch_packed as jbatch_packed, pack_documents as jpack_documents
from repro_torch.data import DataConfig, PrefetchIterator, SyntheticLM, \
    batch_packed, host_local_slice, pack_documents, to_device_batch


@pytest.mark.parametrize("seed", [0, 3, 17])
def test_synthetic_batches_equal_jax(seed):
    """The same numpy generator: every batch, several steps and a start
    step past 0, bit for bit."""
    kw = dict(vocab_size=50288, seq_len=96, global_batch=4, seed=seed)
    mine, ref = SyntheticLM(DataConfig(**kw)), JSynthetic(JDataConfig(**kw))
    for _ in range(3):
        a, b = mine.next(), ref.next()
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    late = SyntheticLM(DataConfig(**kw), start_step=11)
    np.testing.assert_array_equal(
        next(iter(late))["tokens"],
        JSynthetic(JDataConfig(**kw), start_step=11).next()["tokens"])
    assert late.state() == {"step": 12, "seed": seed}


def test_synthetic_structure():
    a = SyntheticLM(DataConfig(vocab_size=128, seq_len=64, global_batch=4,
                               seed=3)).next()
    assert a["tokens"].shape == (4, 64)
    assert a["tokens"].min() >= 1 and a["tokens"].max() < 128
    toks = a["tokens"][0]
    span = toks[-16:]
    assert any((toks[i:i + 16] == span).all() for i in range(0, 64 - 32))


def _docs(rng, n=25, hi=40):
    return [list(rng.integers(1, 99, int(k))) for k in
            rng.integers(1, hi, size=n)]


def test_pack_documents_equals_jax(rng):
    docs = _docs(rng)
    mine = list(pack_documents(docs, seq_len=32))
    ref = list(jpack_documents(docs, seq_len=32))
    assert len(mine) == len(ref)
    for a, b in zip(mine, ref):
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])
    total = sum(len(d) for d in docs)
    assert sum(int((r["segments"] > 0).sum()) for r in mine) == total


def test_batch_packed_equals_jax(rng):
    docs = _docs(rng, n=40, hi=30)
    mine = list(batch_packed(pack_documents(docs, 16), batch=4))
    ref = list(jbatch_packed(jpack_documents(docs, 16), batch=4))
    assert mine and len(mine) == len(ref)
    for a, b in zip(mine, ref):
        assert a["tokens"].shape == (4, 16)
        for k in b:
            np.testing.assert_array_equal(a[k], b[k])


def test_prefetch_iterator_passthrough():
    assert list(PrefetchIterator(iter(range(10)), prefetch=3)) == \
        list(range(10))


def test_prefetch_surfaces_errors():
    def gen():
        yield 1
        raise ValueError("boom")
    it = PrefetchIterator(gen())
    assert next(it) == 1
    with pytest.raises(ValueError, match="boom"):
        next(it)


def test_host_local_slice_is_the_whole_batch_in_one_process():
    assert not torch.distributed.is_initialized()
    assert host_local_slice(8) == slice(0, 8)


def test_to_device_batch_types():
    batch = SyntheticLM(DataConfig(vocab_size=64, seq_len=8,
                                   global_batch=2)).next()
    batch["mask"] = np.ones((2, 8), np.float32)
    got = to_device_batch(batch, "cpu")
    assert got["tokens"].dtype == got["labels"].dtype == torch.int64
    assert got["mask"].dtype == torch.float32
    np.testing.assert_array_equal(got["tokens"].numpy(), batch["tokens"])
