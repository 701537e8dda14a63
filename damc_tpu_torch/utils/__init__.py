"""Host-side utilities of the port: checkpoints, metric logs and image grids,
preemption, host timers and profiler spans."""
