"""A cell cut to a size that a CPU test run holds: its configuration and
traffic as they stand, on a 48x24x8 grid with 2-hour chunks (the physics,
the adaptive dt, the mesh and the schedule kept)."""

from benchmark import harness

SIZE = dict(nx=48, ny=24, nz=8)


def small_cell(name: str, **size):
    cell = harness.load_cell(name)
    cell.namelist["grid"].update(SIZE, **size)
    cell.traffic.update(chunk_hours=2.0, nominal_chunk_s=1.0,
                        trace_chunks=2)
    return cell


def run_small(name: str, seed: int = 4_000_000_011, trace: bool = False,
              **size) -> dict:
    """One run of the cell at the small size on the CPU: the result."""
    return harness.execute(small_cell(name, **size), seed, 3.0, trace,
                           device="cpu")
