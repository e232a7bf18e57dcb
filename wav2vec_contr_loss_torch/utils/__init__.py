"""Run-level utilities: the process group, graceful preemption, metrics
logging and step timing."""
