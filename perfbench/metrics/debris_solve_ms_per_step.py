"""Device ms a step of the debris solve, between the fluvial_end and
debris_end marks (moves cell_steps_per_s); see `perfbench.marks`."""

from perfbench.marks import debris_solve_ms_per_step as read  # noqa: F401
