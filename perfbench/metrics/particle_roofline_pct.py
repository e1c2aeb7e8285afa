"""The particle trajectory kernels' share of their byte roofline, %, in the
particle cell (moves cell_steps_per_s.small); see
`perfbench.readers.particle_roofline_pct`."""

from perfbench.readers import particle_roofline_pct as read  # noqa: F401
