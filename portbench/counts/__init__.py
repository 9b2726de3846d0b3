"""Operation and byte counts of the benchmark's kernels and steps, computed
from the configuration's shapes and each run's ROI counts, so they read the
same work whatever implements it."""
