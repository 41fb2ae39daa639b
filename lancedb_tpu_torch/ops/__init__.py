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
    kmeans_assign,
    kmeans_assign_device,
    kmeans_fit,
    kmeans_fit_device,
    kmeanspp_init_device,
)
from .pq import (
    adc_lut,
    adc_scan_lut,
    default_num_sub_vectors,
    opq_train,
    pq_build_device,
    pq_encode,
    pq_encode_rnorms,
    pq_reconstruct,
    pq_reconstruct_device,
    pq_train,
)
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
    "kmeans_assign",
    "kmeans_assign_device",
    "kmeans_fit",
    "kmeans_fit_device",
    "kmeanspp_init_device",
    "adc_lut",
    "adc_scan_lut",
    "default_num_sub_vectors",
    "opq_train",
    "pq_build_device",
    "pq_encode",
    "pq_encode_rnorms",
    "pq_reconstruct",
    "pq_reconstruct_device",
    "pq_train",
    "mask_and_topk",
    "merge_topk",
    "topk_smallest",
]
