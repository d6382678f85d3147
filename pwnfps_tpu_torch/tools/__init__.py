"""The port's measurement tools, counterparts of the JAX package's
tools/launch_probe.py, tools/vpu_probe.py and tools/occupancy.py.  Run
them as `python -m pwnfps_tpu_torch.tools.<name>`; each runs on the card
unless given `--device cpu`."""
