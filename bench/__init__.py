"""The benchmark of the PyTorch port (`repro_torch`) on one H100.

`python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>` serves one cell of `BENCHMARK.json` once and prints one JSON line.
Everything that belongs to one configuration, traffic mix, per-layer metric
or cell is a file of its own, found by its name:
`bench/configs/<config>.json`, `bench/traffic/<traffic>.json`,
`bench/metrics/<metric>.py` and `bench/limits/<cell>.json`.
"""
