"""Run-level utilities: graceful preemption."""
