"""The port's copy of the data pipeline (``repro_torch.data``): the cases of
the reference's ``TestData`` (``tests/test_serving_training.py``) re-run on
the port, and packed batches, buckets and padding waste equal to the JAX
package's for the same ``DataConfig``."""

import dataclasses

import numpy as np
import pytest

pytest.importorskip("torch")

try:
    from hypothesis import given, settings, strategies as st
except ImportError:     # clean checkout: seeded-random fallback
    from proptest_fallback import given, settings, st

from torch_parity import PACKAGES, package  # noqa: E402

from repro_torch.data import (DataConfig, Prefetcher,  # noqa: E402
                              SyntheticCorpus, pack_documents, padding_waste)


class TestData:
    def test_packing_shapes_and_determinism(self):
        dc = DataConfig(vocab=1000, seq_len=64, batch=4, seed=7)
        b1 = list(pack_documents(SyntheticCorpus(dc), 3))
        b2 = list(pack_documents(SyntheticCorpus(dc), 3))
        for x, y in zip(b1, b2):
            assert x["tokens"].shape == (4, 64)
            np.testing.assert_array_equal(x["tokens"], y["tokens"])
            # labels are next-token shifted
        dc2 = dataclasses.replace(dc, seed=8)
        b3 = next(iter(pack_documents(SyntheticCorpus(dc2), 1)))
        assert not np.array_equal(b1[0]["tokens"], b3["tokens"])

    @given(st.lists(st.integers(1, 2048), min_size=1, max_size=100))
    @settings(max_examples=30, deadline=None)
    def test_bucketing_reduces_padding_waste(self, lengths):
        w_b = padding_waste(lengths, bucketed=True)
        w_n = padding_waste(lengths, bucketed=False)
        assert 0.0 <= w_b <= 1.0
        assert w_b <= w_n + 1e-9

    def test_prefetcher_preserves_order(self):
        items = list(range(20))
        assert list(Prefetcher(iter(items), depth=3)) == items


def _packed(pkg: str, **kw) -> list[dict]:
    D = package(pkg, "data.pipeline")
    corpus = D.SyntheticCorpus(D.DataConfig(**kw))
    return list(D.Prefetcher(D.pack_documents(corpus, 4), depth=2))


@pytest.mark.parametrize("kw", [
    dict(vocab=1000, seq_len=64, batch=4, seed=7),
    dict(vocab=151_936, seq_len=256, batch=2, doc_len_mean=64, seed=3),
    dict(vocab=50, seq_len=17, batch=3, zipf_a=1.5, eos=1, seed=0),
], ids=["small", "qwen3_vocab", "odd_shape"])
def test_packed_batches_equal_the_reference(kw):
    ref, port = (_packed(p, **kw) for p in PACKAGES)
    assert len(port) == len(ref) == 4
    for x, y in zip(port, ref):
        assert x.keys() == y.keys() == {"tokens", "labels"}
        for k in x:
            assert x[k].dtype == y[k].dtype
            np.testing.assert_array_equal(x[k], y[k])
        np.testing.assert_array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])


@given(st.lists(st.integers(1, 4096), min_size=1, max_size=80))
@settings(max_examples=30, deadline=None)
def test_buckets_and_waste_equal_the_reference(lengths):
    ref, port = (package(p, "data.pipeline") for p in PACKAGES)
    assert port.length_buckets(lengths) == ref.length_buckets(lengths)
    for bucketed in (False, True):
        assert (port.padding_waste(lengths, bucketed)
                == ref.padding_waste(lengths, bucketed))
