"""What decides ``correct``: the plain reference follows the stretch of the
window that the seed drew (one runner call of ``cli.run``: its graph
replays of both parities, the predictor, the corrector with the physics
epilogue, a radiation refresh, and the dt the host loop chose for it) and
its fields are held against the program's, each by a limit of its own.

The reference is the package that the configuration names
(``harness.reference_of``), run at the configuration's working precision.
It starts from the program's own state at the start of that
chunk (the fields and the radiation caches that the program carried in):
a run of the reference from the seeded state through every earlier chunk
would take longer than the window. The start is checked by itself: the
window's first input has to equal the seeded arrays exactly. The
reference works out the grid, the forcing, the chunk's dt and every
radiation refresh within the chunk again from the configuration.
"""

from __future__ import annotations

import math

import torch

# the fields held against the reference after the chunk: the dynamics'
# prognostics, the surface temperature (surface model) and the radiative
# heating (the refresh within the chunk); the microphysics and turbulence
# act on pott, qv and the winds
COMPARED = ("u", "v", "colp", "pott", "qv", "tsurf", "dpottdt_rad")


def max_gap(a, b) -> float:
    d = (a.double() - b.double().to(a.device)).abs().max()
    v = float(d)
    return v if math.isfinite(v) else math.inf


def start_gap(start: dict, arrays: dict) -> float:
    """The largest difference between the window's first input and the
    seeded arrays, cast as the restart cast them (0 when exact)."""
    gap = 0.0
    for f, x in start["fields"].items():
        ref = torch.as_tensor(arrays[f]).to(x.dtype)
        gap = max(gap, max_gap(x, ref))
    gap = max(gap, abs(float(start["t"]) - float(arrays["t"])),
              abs(int(start["step"]) - int(arrays["step"])))
    return gap


def follow(ref, rcfg, snaps: dict, arrays: dict, call: dict,
           device) -> dict:
    """The readings of a run: ``start`` (the window's first input against
    the seed), ``dt`` (the chunk's dt against the host loop's rule worked
    out again) and, for each ``COMPARED`` field, the largest difference
    between the program's state after the chunk and that of the reference
    ``ref`` (``harness.Reference``), run from the chunk's input for as many
    steps."""
    dev = ref.model.reference_device(device)
    readings = dict(start=start_gap(snaps["start"], arrays))
    s_in, s_out = snaps["in"], snaps["out"]
    out, dt = reference_chunk(ref, rcfg, s_in, call["n"], dev)
    readings["dt"] = abs(float(call["dt"]) - dt)
    readings["steps"] = abs(int(s_out["step"]) - out.step)
    for f in COMPARED:
        readings[f] = max_gap(getattr(out, f), s_out["fields"][f])
    return readings


def reference_chunk(ref, rcfg, s_in: dict, n: int, dev, store=None):
    """The state of the reference ``ref`` after ``n`` steps from snapshot
    ``s_in``, at the configuration's working precision (``rcfg.dtype``)
    and the dt the host loop's rule gives, and that dt. With ``store`` (the
    control) the state is rounded to that dtype before the first step and
    after every step."""
    m = ref.model
    dtype = getattr(torch, rcfg.dtype)
    grid, forcing = m.build(rcfg, dev, dtype)
    state = m.make_state(s_in["fields"], s_in["t"], s_in["step"], dev,
                         dtype)

    def held(st):
        if store is None:
            return st
        return st.replace(**{f: getattr(st, f).to(store).to(dtype)
                             for f in m.STATE_FIELDS})

    state = held(state)
    dt = m.chunk_dt(state, grid, rcfg)
    grid = grid.replace(dt=dt)
    with torch.no_grad():
        for _ in range(n):
            state = held(m.step(state, grid, forcing, rcfg))
    return state, dt


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]): every limited reading at or under
    its limit; a reading that is missing or not finite fails."""
    lines, ok = [], True
    for name, limit in limits.items():
        v = readings.get(name, math.inf)
        good = v is not None and math.isfinite(v) and v <= limit
        ok = ok and good
        lines.append((name, v, limit))
    return ok, lines
