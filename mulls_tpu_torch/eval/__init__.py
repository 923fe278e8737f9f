from mulls_tpu_torch.eval.kitti_metrics import (
    SegmentError, compute_error, summarize, format_report, ate_rmse,
)

__all__ = ["SegmentError", "compute_error", "summarize", "format_report",
           "ate_rmse"]
