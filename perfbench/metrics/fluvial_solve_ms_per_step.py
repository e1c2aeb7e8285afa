"""Device ms a step of the fluvial solve, between the step_begin and
fluvial_end marks (moves cell_steps_per_s); see `perfbench.marks`."""

from perfbench.marks import fluvial_solve_ms_per_step as read  # noqa: F401
