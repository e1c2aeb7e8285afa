"""The device's idle share inside the captured step, between its
step_begin and step_end marks (moves cell_steps_per_s); see
`perfbench.marks`."""

from perfbench.marks import step_idle_pct as read  # noqa: F401
