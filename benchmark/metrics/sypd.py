"""Simulated years per wall-clock day over the whole window (CPMIP's SYPD,
Balaji et al., GMD 10, 19-34, 2017): simulated time over the window's
wall time, from the host clock."""


def read(run: dict):
    return run["sim_s"] / run["wall_s"] / 365.0
