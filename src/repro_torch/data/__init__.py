"""Data pipeline: synthetic corpus, packing, length bucketing, prefetch."""
from repro_torch.data.pipeline import (DataConfig, Prefetcher, SyntheticCorpus,
                                 length_buckets, pack_documents,
                                 padding_waste)
__all__ = ["DataConfig", "Prefetcher", "SyntheticCorpus", "length_buckets",
           "pack_documents", "padding_waste"]
