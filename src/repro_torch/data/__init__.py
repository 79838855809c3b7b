"""Synthetic data of the port (numpy; bit-identical to the reference's)."""
from .pipeline import (
    DataConfig,
    bigram_table,
    class_balanced_partition,
    epoch_permutations,
    lm_batch_numpy,
    make_classification_data,
    synthetic_batches,
    synthetic_lm_batch,
    token_pipeline,
)

__all__ = [
    "DataConfig", "bigram_table", "class_balanced_partition", "epoch_permutations",
    "lm_batch_numpy", "make_classification_data", "synthetic_batches",
    "synthetic_lm_batch", "token_pipeline",
]
