"""The benchmark of the PyTorch and CUDA erosion port (`soillib_tpu_torch`)
on NVIDIA GPUs: `python3 -m perfbench.run --workload <cell> --seed <n>
--seconds <s> --trace <0|1>` from the repository root. Cells are named in
BENCHMARK.json; their configurations, traffic mixes, limits and per-layer
metric readers are files of this folder found by name."""
