"""Seconds from the start of the process (on four cards, of the process
that starts the ranks) to the window's opening: imports, the kernel build
or load, the seeded state and its restart file, the port's initialize, the
restart read and the first chunk with its graph capture."""


def read(run: dict):
    return run["setup_s"]
