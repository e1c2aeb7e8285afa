"""Device ms a step of the graph's write-back into its buffers, between the
update_end and step_end marks (moves cell_steps_per_s); see
`perfbench.marks`."""

from perfbench.marks import writeback_ms_per_step as read  # noqa: F401
