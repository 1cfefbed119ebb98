"""The trainer's rate in the traced run: the env steps of the rollout steps
completed in the window over its length, the updates inside it counted in
its time (the host's clock; the profiler slows the host, so it reads below
an untraced run's rate)."""


def read(run):
    return run.metrics.get("env_steps_per_s.train")
