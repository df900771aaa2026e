"""Coarse-filter index layer between the EmbeddingStore and the scan
kernels: ``index.ivf`` is the online mini-batch-k-means IVF quantizer with
its posting lists, ``index.pruned_scan`` the probe selection, candidate-row
building, numpy oracle and recall harness."""
from repro_torch.index.ivf import IVFIndex, ReclusterJob  # noqa: F401
