"""setup_s: from the start of the benchmark's process to the window:
imports, the kernel library's load (its build on a checkout's first run),
the database's generation and bucketed staging, and one search of every
library profile."""


def read(w):
    return w.setup_s
