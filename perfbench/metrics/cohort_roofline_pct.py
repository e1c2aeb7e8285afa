"""The cohort round kernels' share of their roofline, %, in the 4096^2 cells
(moves cell_steps_per_s); see `perfbench.readers.cohort_roofline_pct`."""

from perfbench.readers import cohort_roofline_pct as read  # noqa: F401
