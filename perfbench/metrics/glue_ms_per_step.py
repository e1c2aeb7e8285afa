"""Device ms a step outside the cohort rounds, in the 4096^2 cells (moves
cell_steps_per_s); see `perfbench.readers.glue_ms_per_step`."""

from perfbench.readers import glue_ms_per_step as read  # noqa: F401
