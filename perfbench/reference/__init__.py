"""The plain reference of the measured erosion step (`step.erode_step`),
in plain torch, importing nothing of the measured program."""
