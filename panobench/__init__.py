"""The benchmark of simplepanorama_tpu_torch, the stitcher's PyTorch and
CUDA port: ``python3 panobench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>`` (see ``run.py``)."""
