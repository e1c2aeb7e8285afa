"""Device kernels a step, in the 4096^2 cells (moves cell_steps_per_s); see
`perfbench.readers.kernels_per_step`."""

from perfbench.readers import kernels_per_step as read  # noqa: F401
