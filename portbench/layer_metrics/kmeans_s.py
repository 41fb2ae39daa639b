"""Seconds a build spends in the coarse k-means and assignment
(``ivf_train_assign_device``, the entry ``build_vector_index`` calls),
each span ended on a device synchronize, mean over the window's builds."""

from portbench.readers import KMEANS as SPANS, s_per_build  # noqa: F401


def read(t):
    return s_per_build(t, "kmeans")
