"""The benchmark of the PyTorch/CUDA port (pwnfps_tpu_torch).

`python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell once on one card (see run.py and
harness.py).  The program under test is driven only through its public
entries; the yardstick (traffic, reference, work arithmetic, trace
reading) lives here, where later changes to the program cannot move it.
"""
