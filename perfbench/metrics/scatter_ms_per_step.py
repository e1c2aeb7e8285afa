"""Device ms a step of the particle estimators' index_add_ scatter (moves
cell_steps_per_s.small); see `perfbench.readers.scatter_ms_per_step`."""

from perfbench.readers import scatter_ms_per_step as read  # noqa: F401
