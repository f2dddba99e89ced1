"""Evaluation layer (port of ``eval/``): graph statistics, causal
distances, GC-estimate dispatch, cross-algorithm comparison, dynamic
readouts, factor scoring, system-level scoring and grid-search selection,
exported under the JAX package's names.

Not ported yet (ROADMAP queue 1): ``eval/analysis.py`` and the plotting it
needs, and ``eval/supervised_discovery.py`` (needs the PCMCI and
tidybench baselines). Importing this package builds and imports nothing
CUDA-specific.
"""
from redcliff_tpu_torch.eval.causal_distances import (ancestor_aid, oset_aid,
                                                      parent_aid, shd)
from redcliff_tpu_torch.eval.cross_alg import (
    ALL_POSSIBLE_ALGORITHMS,
    evaluate_algorithm_on_fold,
    find_run_directory,
    read_in_true_causal_graphs_for_all_datasets,
    run_cross_algorithm_comparison,
)
from redcliff_tpu_torch.eval.dynamic_readout import (
    evaluate_dynamic_readouts_on_fold,
    run_dynamic_readout_evaluation,
)
from redcliff_tpu_torch.eval.edge_dynamics import (
    compute_edge_lock_performance_v3_stats,
    compute_edge_lock_performance_v4_stats,
    compute_edge_rank_performance_v1_stats,
    compute_edge_rank_performance_v2_stats,
    compute_key_edge_correlation_stats,
    compute_key_edge_covariance_stats,
    compute_smoothed_edge_cross_edge_rank_covariance_stats,
    compute_smoothed_edge_rank_covariance_stats,
    evaluate_dynamic_graph_estimates,
)
from redcliff_tpu_torch.eval.factor_scoring import (
    average_factor_scoring_by_state,
    evaluate_avg_factor_scoring_across_recordings,
    factor_score_sweep,
)
from redcliff_tpu_torch.eval.gc_estimates import (
    get_model_gc_estimates,
    get_model_gc_score_estimates,
    get_model_gc_summary_matrices,
)
from redcliff_tpu_torch.eval.grid_selection import (
    average_factor_histories,
    filter_incomplete_runs,
    load_grid_summaries,
    rank_runs,
    select_best_models,
)
from redcliff_tpu_torch.eval.model_io import load_artifact, load_model_for_eval
from redcliff_tpu_torch.eval.stats import (
    compute_fixed_f1_stats,
    compute_graph_comparison_stats,
    compute_key_stats,
    compute_optimal_f1_stats,
    summarize_values,
    three_view_optimal_f1_stats,
)
from redcliff_tpu_torch.eval.summaries import (
    extract_metric_table,
    load_full_comparison_summary,
    summarize_off_diag_f1,
    write_cross_experiment_report,
)
from redcliff_tpu_torch.eval.system_level import (
    evaluate_fold_system_level,
    evaluate_system_level_cv,
    evaluate_system_level_gs,
    key_similarity_stats,
)

__all__ = [
    "ancestor_aid", "oset_aid", "parent_aid", "shd",
    "compute_edge_lock_performance_v3_stats",
    "compute_edge_lock_performance_v4_stats",
    "compute_edge_rank_performance_v1_stats",
    "compute_edge_rank_performance_v2_stats",
    "compute_key_edge_correlation_stats",
    "compute_key_edge_covariance_stats",
    "compute_smoothed_edge_cross_edge_rank_covariance_stats",
    "compute_smoothed_edge_rank_covariance_stats",
    "evaluate_dynamic_graph_estimates",
    "ALL_POSSIBLE_ALGORITHMS", "evaluate_algorithm_on_fold",
    "find_run_directory", "read_in_true_causal_graphs_for_all_datasets",
    "run_cross_algorithm_comparison",
    "evaluate_dynamic_readouts_on_fold", "run_dynamic_readout_evaluation",
    "get_model_gc_estimates", "get_model_gc_score_estimates",
    "get_model_gc_summary_matrices",
    "average_factor_histories", "filter_incomplete_runs",
    "load_grid_summaries", "rank_runs", "select_best_models",
    "load_artifact", "load_model_for_eval",
    "average_factor_scoring_by_state",
    "evaluate_avg_factor_scoring_across_recordings", "factor_score_sweep",
    "extract_metric_table", "load_full_comparison_summary",
    "summarize_off_diag_f1", "write_cross_experiment_report",
    "evaluate_fold_system_level", "evaluate_system_level_cv",
    "evaluate_system_level_gs", "key_similarity_stats",
    "compute_fixed_f1_stats", "compute_graph_comparison_stats",
    "compute_key_stats", "compute_optimal_f1_stats", "summarize_values",
    "three_view_optimal_f1_stats",
]
