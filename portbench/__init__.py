"""The benchmark of the PyTorch and CUDA port ``pymc3_tpu_torch`` on an
NVIDIA H100: ``python3 -m portbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>``. See ``portbench/harness.py``."""
