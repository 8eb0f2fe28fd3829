"""The benchmark of the PyTorch and CUDA port (``scnerf_tpu_torch``): run
``python -m portbench --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` from the root of a checkout; see ``README.md``."""
