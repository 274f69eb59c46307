"""Pipelines, batching, the tree cascade, ensembles, metrics and report writers
of the port."""
from av1tpu_torch.eval.cascade import decompose_v6  # noqa: F401
from av1tpu_torch.eval.compare import (  # noqa: F401
    compare_operating_points,
    compose_final,
    render_markdown,
)
from av1tpu_torch.eval.ensemble import (  # noqa: F401
    ensemble_diversity,
    fit_stacking,
    hard_vote,
    load_ensemble,
    predict_with_uncertainty,
    save_ensemble,
    soft_vote,
    stacked_member_logits,
    stacking_predict,
    tta_logits,
    weighted_vote,
)
from av1tpu_torch.eval.folded import make_v6_pipeline_folded  # noqa: F401
from av1tpu_torch.eval.gated import auto_capacity, make_v6_pipeline_gated  # noqa: F401
from av1tpu_torch.eval.hierarchy import (  # noqa: F401
    PipelineModels,
    assemble_v6_predict,
    make_v6_pipeline,
    run_pipeline_batched,
    v6_route,
)
from av1tpu_torch.eval.metrics import (  # noqa: F401
    best_by,
    classification_report_text,
    compute_binary_metrics,
    compute_metrics,
    confusion,
    expected_calibration_error,
    find_optimal_threshold,
    fit_temperature,
    roc_auc,
    threshold_sweep,
)
from av1tpu_torch.eval.report import (  # noqa: F401
    write_metrics_json,
    write_predictions_csv,
    write_predictions_npz,
    write_text_report,
)
from av1tpu_torch.eval.tree_infer import (  # noqa: F401
    predict_frame_trees,
    predict_partition_trees,
    quad_tile_on_device,
)
from av1tpu_torch.eval.tree_metrics import tree_accuracy  # noqa: F401
from av1tpu_torch.eval.unified import (  # noqa: F401
    make_unified_pipeline,
    make_unified_pipeline_folded,
)
