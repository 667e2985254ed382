"""The benchmark of the PyTorch and CUDA port (``pytorchwavenetvocoder_tpu_torch``).

Run one cell: ``python3 -m port_bench --workload <name> --seed <n>
--seconds <s> --trace <0|1>`` (see ``README.md``).  Nothing here imports
JAX or the JAX package; ``reference/`` imports nothing of the program.
"""
