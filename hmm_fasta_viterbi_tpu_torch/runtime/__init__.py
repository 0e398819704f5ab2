"""runtime subpackage: the engine configuration, the profiler trace and
section timer, and resumable checkpointed sweeps."""
