"""Device compute in PyTorch, plus the hand-written CUDA kernels (csrc/)."""

from .adc import (
    ivf_pq_adc_grouped_scan,
    ivf_pq_adc_grouped_scan_reference,
    ivf_pq_adc_scan,
    ivf_pq_adc_scan_reference,
    launch_counts,
    reset_launch_counts,
)
from .flat_scan import ivf_flat_grouped_scan, ivf_flat_scan, ivf_flat_scan_reference
from .distance import normalize_metric, pairwise_distance, refine_distances, squared_norms
from .kmeans import (
    assign_residuals_device,
    ivf_train_assign_device,
    kmeans_fit_device,
    kmeanspp_init_device,
)
from .pq import default_num_sub_vectors, pq_build_device
from .topk import mask_and_topk, merge_topk, topk_smallest

__all__ = [
    "ivf_pq_adc_grouped_scan",
    "ivf_pq_adc_grouped_scan_reference",
    "ivf_pq_adc_scan",
    "ivf_pq_adc_scan_reference",
    "launch_counts",
    "reset_launch_counts",
    "ivf_flat_grouped_scan",
    "ivf_flat_scan",
    "ivf_flat_scan_reference",
    "normalize_metric",
    "pairwise_distance",
    "refine_distances",
    "squared_norms",
    "assign_residuals_device",
    "ivf_train_assign_device",
    "kmeans_fit_device",
    "kmeanspp_init_device",
    "default_num_sub_vectors",
    "pq_build_device",
    "mask_and_topk",
    "merge_topk",
    "topk_smallest",
]
