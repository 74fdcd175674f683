"""Device kernels per frame of the traced stretch (the profiler's
count; it can drop events on a busy host, which the run's earlier line
reports against K2's own launch counter)."""


def read(run):
    p = run.profile
    if not p or not run.profile_frames:
        return None
    return len(p["kernels"]) / len(run.profile_frames)
