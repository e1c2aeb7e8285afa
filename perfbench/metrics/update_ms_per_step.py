"""Device ms a step of the update (blend, transfer, creep, albedo), between
the debris_end and update_end marks (moves cell_steps_per_s); see
`perfbench.marks`."""

from perfbench.marks import update_ms_per_step as read  # noqa: F401
