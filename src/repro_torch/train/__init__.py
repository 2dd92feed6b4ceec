"""Training of the port: the optimizers (`optimizer`), the train step
(`train_step`), checkpoints (`checkpoint`) and fault tolerance (`fault`:
preemption guard, straggler watchdog, restart supervisor; the fleet's
replicas use its watchdog)."""
