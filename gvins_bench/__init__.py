"""The benchmark of the PyTorch and CUDA port (``ic_gvins_tpu_torch``): run
``python3 gvins_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` from the repository root. It imports nothing of JAX or of
the JAX package."""
