"""The benchmark's plain reference, independent of the program under test.

A frozen copy of the port's plain torch path (its modules under core/,
world/, ops/ and render/ name their sources in their first lines) with
the benchmark's own entry points:

  * `worlds/<kind>.py`: the world of a configuration, rebuilt from its
    raw inputs (a level file, a sphere list, the SSE table dump);
  * `pixels.py`: any pixels of a frame (framebuffer after the DoF passes,
    and depth), traced and blurred in plain torch, and the work counts of
    a whole frame that the tracer's roofline reads.

Nothing here imports pwnfps_tpu_torch, pwnfps_tpu or jax, and nothing
takes a table, a weight or a tensor that the program made.
"""
