"""Seeded synthetic stand-ins for the paper's LIBSVM datasets."""
from repro_torch.data.libsvm_like import (
    PAPER_DATASETS,
    DatasetSpec,
    load,
    make_classification,
)
