"""The seeded inputs of a run: the configuration's analytic initial state,
made by the reference's frozen copy of the init in float64 NumPy, with a
seeded perturbation of POTT and QV, as the members of an ensemble are made:
every cell perturbs alike (``POTT_K``, ``QV_REL``).

The same seed gives the same arrays; every seed gives the same sizes, so the
work of a run does not depend on its seed. The program gets them as a
restart file (``cli.run``'s ``restart_from``); the reference gets the same
arrays. The init is the one of the reference that judges the configuration
(``harness.reference_of``).
"""

from __future__ import annotations

import numpy as np

# the radiation caches start empty: the first step refreshes them
_CACHES3 = ("dpottdt_rad",)
_CACHES2 = ("swflx_sfc", "lwflx_sfc")
# the perturbation: POTT plus 0.1 K of white noise, QV times (1 + 1 % of
# white noise)
POTT_K = 0.1
QV_REL = 0.01


def seeded_state(ref, cfg, seed: int) -> dict:
    """Float64 arrays of every State field, ``t`` 0 and ``step`` 0:
    POTT plus ``POTT_K`` K of white noise, QV times (1 + ``QV_REL`` of
    white noise), clipped at 0. ``ref`` is the reference
    (``harness.Reference``), ``cfg`` its config."""
    st, _, _ = ref.init.initial_state_np(cfg)
    rng = np.random.default_rng(int(seed))
    shape3 = st["pott"].shape
    st["pott"] = st["pott"] + POTT_K * rng.standard_normal(
        shape3, dtype=np.float32)
    st["qv"] = np.maximum(st["qv"] * (1.0 + QV_REL * rng.standard_normal(
        shape3, dtype=np.float32)), 0.0)
    for f in _CACHES3:
        st[f] = np.zeros(shape3)
    for f in _CACHES2:
        st[f] = np.zeros(shape3[1:])
    st["t"] = np.zeros(())
    st["step"] = np.asarray(0, np.int32)
    return st


def compared_chunk(seed: int, n_chunks: int) -> int:
    """Which of the window's runner calls (1 .. n_chunks, call 0 being the
    first chunk, in set-up) the reference follows, drawn from the seed."""
    rng = np.random.default_rng([int(seed), 1])
    return int(rng.integers(1, n_chunks + 1))
