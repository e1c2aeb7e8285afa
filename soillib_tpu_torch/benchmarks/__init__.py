"""The port's twins of the JAX repo's study harnesses (`benchmarks/`):

* `parity`: the field solve against the converged particle Monte-Carlo
  oracle, per field, terrain and regime, and over coupled trajectories;
* `residual_probe`, `age_deficit_probe`: the single-origin probes of the
  closure residual;
* `scaling`: the weak-scaling harness of the sharded step over
  `parallel.launch`.

Each runs as `python -m soillib_tpu_torch.benchmarks.<name>` with the JAX
script's flags and JSON keys, on the card unless `--cpu` is given (no
card and no `--cpu` raises). Importing a module runs nothing. Their
records from the card are in `records/`.
"""
