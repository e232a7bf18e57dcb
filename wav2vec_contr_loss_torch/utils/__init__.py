"""Run-level utilities: the process group, graceful preemption, metrics
logging, named spans and the profiler exporter."""
