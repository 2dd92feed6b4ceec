"""Training-side utilities of the port.  Only `fault` (preemption guard,
straggler watchdog, restart supervisor) is ported so far; the fleet's
replicas use its watchdog."""
