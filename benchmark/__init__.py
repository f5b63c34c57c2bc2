"""The PyTorch/CUDA port's benchmark: one cell per configuration and
traffic, run as `python3 benchmark/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`."""
