"""Evaluation suite of the port (`dimsum_tpu/eval`): FID, KID, the
Inception Score, precision/recall and PPL over pluggable detectors, the
FID InceptionV3 on the card, and the metric registry."""

from dimsum_torch.eval.fid import (  # noqa: F401
    FeatureStats,
    compute_fid,
    compute_inception_score,
    compute_kid,
    compute_precision_recall,
    frechet_distance,
)
from dimsum_torch.eval.features import (  # noqa: F401
    RandomProjectionDetector,
    TorchScriptDetector,
    batched_features,
    detector_id,
    latents_to_uint8,
    make_detector,
)
from dimsum_torch.eval.metric_main import (  # noqa: F401
    calc_metric,
    calc_metrics_many,
    calc_metrics_multiprocess,
    is_valid_metric,
    list_valid_metrics,
    report_metric,
)
