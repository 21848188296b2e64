"""Seeded synthetic stand-ins for the paper's LIBSVM datasets, and the
synthetic LM token streams."""
from repro_torch.data.libsvm_like import (
    PAPER_DATASETS,
    DatasetSpec,
    load,
    make_classification,
)
from repro_torch.data.lm_stream import FastLMStream, LMStream
