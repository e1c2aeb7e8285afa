"""Host seconds of the program's graph set-up (warm-up step, capture,
instantiation) in the run's process (moves setup_s); see
`perfbench.marks`."""

from perfbench.marks import graph_setup_s as read  # noqa: F401
