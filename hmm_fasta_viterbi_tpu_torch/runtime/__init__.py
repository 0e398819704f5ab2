"""runtime subpackage: the section timer and resumable checkpointed sweeps."""
