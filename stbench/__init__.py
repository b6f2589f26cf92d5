"""The benchmark of the PyTorch and CUDA port (`st_dadk_tpu_torch`): one
cell a run, `python3 -m stbench --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` (`stbench/run.py`)."""
