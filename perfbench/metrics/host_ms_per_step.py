"""Host ms a step of the driver's step() call, in the 4096^2 cells (moves
cell_steps_per_s); see `perfbench.readers.host_ms_per_step`."""

from perfbench.readers import host_ms_per_step as read  # noqa: F401
