"""Data layer (port of ``redcliff_tpu/data``): synthetic sVAR generation
(``synthetic.py``, host and device halves), synthetic-fold curation
(``curation.py``), DREAM4/D4IC curation (``dream4.py``), LFP preprocessing
(``lfp.py``), the shard layout and its loaders (``shards.py``), the dataset
containers (``datasets.py``) and the stream modes (``pipeline.py``).

The exports are the JAX package's, under the same names (the streaming
``ShardedBatchDataset`` since the production-runtime slice). Importing the
package builds and loads nothing CUDA-specific.
"""
from redcliff_tpu_torch.data.datasets import ArrayDataset, train_val_split
from redcliff_tpu_torch.data.dream4 import (
    D4IC_SNR_TIERS,
    make_d4ic_fold,
    make_dream4_combo_dataset,
    make_dream4_individual_dataset,
    make_dream4_single_dominant_superpositional_dataset,
    parse_dream4_timeseries,
)
from redcliff_tpu_torch.data.lfp import (
    determine_keys_of_interest,
    extract_epoch_windows,
    load_lfp_data_matrix,
    preprocess_socpref_raw_lfps_for_windowed_training,
    preprocess_tst_raw_lfps_for_windowed_training,
)
from redcliff_tpu_torch.data.pipeline import (
    PrefetchIterator,
    choose_stream_mode,
    dispatch_budget,
    epoch_batch_plan,
    prefetch_batches,
)
from redcliff_tpu_torch.data.shards import (
    ShardedBatchDataset,
    apply_signal_format,
    load_normalized_split_datasets,
    load_shard_samples,
    samples_to_arrays,
    save_cv_split,
)

__all__ = [
    "ArrayDataset", "train_val_split",
    "choose_stream_mode", "dispatch_budget", "epoch_batch_plan",
    "prefetch_batches", "PrefetchIterator",
    "D4IC_SNR_TIERS", "make_d4ic_fold", "make_dream4_combo_dataset",
    "make_dream4_individual_dataset",
    "make_dream4_single_dominant_superpositional_dataset",
    "parse_dream4_timeseries",
    "determine_keys_of_interest", "extract_epoch_windows",
    "load_lfp_data_matrix",
    "preprocess_socpref_raw_lfps_for_windowed_training",
    "preprocess_tst_raw_lfps_for_windowed_training",
    "apply_signal_format", "load_normalized_split_datasets",
    "load_shard_samples", "samples_to_arrays", "save_cv_split",
    "ShardedBatchDataset",
]
