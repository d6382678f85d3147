"""The port's measurement tools, counterparts of the JAX package's
tools/launch_probe.py and tools/vpu_probe.py.  Run them as
`python -m pwnfps_tpu_torch.tools.<name>`; each runs on the card unless
given `--device cpu`."""
