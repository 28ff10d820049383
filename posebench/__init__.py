"""The benchmark of the PyTorch / CUDA port (`articulated_pose_tpu_torch`).

`python3 posebench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of `BENCHMARK.json` once on the card and
prints one JSON result line.  Everything that belongs to one cell,
configuration, traffic mix or per-layer metric is a file of its own,
found by the name `BENCHMARK.json` gives it:

- `configs/<config>.json`: the model and fit configuration as it runs;
- `traffic/<traffic>.json`: the parameters the general generators of
  `traffic/` read;
- `workloads/<cell>.json`: which of `drivers/` runs the cell, and the
  limits of the numbers that decide `correct`;
- `drivers/<driver>.py`: set-up, the measured window, the trace and the
  comparison with the plain reference (`reference/`);
- `metrics/<metric>.py`: the reader of one per-layer metric.

Nothing here imports JAX or the JAX package (`articulated_pose_tpu`),
and `reference/` imports nothing of the port.
"""
