"""The harness: deployments and mixes found by name, the recording
generator, the runner, the profiler's reduction, the check."""
