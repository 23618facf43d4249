"""The benchmark of the PyTorch and CUDA port, ``wsinsight_tpu_torch``.

One command runs one cell of ``BENCHMARK.json`` on the card it is started on:

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

See ``portbench/README.md`` for the layout: configurations, traffic mixes,
drivers, per-layer metric readers, the frozen roofline counts and the plain
reference that decides ``correct``.
"""
