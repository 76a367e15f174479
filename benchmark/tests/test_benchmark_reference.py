"""The reference matches the port's plain per-step path on the CPU at a
small grid, step for step, in float64 (the port's own tests hold that path
to the JAX package)."""

import torch

from benchmark import harness, inputs
from benchmark.reference import model as ref
from benchmark.reference.config import config_from_dict

from ._small import small_cell


def test_reference_equals_the_ports_plain_path():
    from climate_model_tpu_torch.core.init import initialize
    from climate_model_tpu_torch.core.namelist import config_from_dict as pc
    from climate_model_tpu_torch.dycore.stepper import step_matsuno
    from climate_model_tpu_torch.io.convert import state_from_numpy
    from climate_model_tpu_torch.model import make_step_fn

    cell = small_cell("bl3_run")
    nl = harness.run_namelist(cell, 2)
    nl["dtype"] = "float64"
    pcfg, rcfg = pc(dict(nl)), config_from_dict(dict(nl))
    arrays = inputs.seeded_state(harness.reference_of(cell), rcfg, 77)
    _, pforcing, pgrid = initialize(pcfg, device="cpu")
    pstate = state_from_numpy(arrays, device="cpu", dtype=torch.float64)
    pstep = make_step_fn(pcfg, dynamics=lambda s, g, f: step_matsuno(
        s, g, f, pcfg))
    grid, forcing = ref.build(rcfg, "cpu", torch.float64)
    rstate = ref.make_state(arrays, arrays["t"], 0, "cpu", torch.float64)
    assert grid.dt == pgrid.dt
    n = 2 * rcfg.physics.rad_every_steps + 1      # two refreshes
    for _ in range(n):
        pstate = pstep(pstate, pgrid, pforcing)
        rstate = ref.step(rstate, grid, forcing, rcfg)
    for f in ref.STATE_FIELDS:
        assert torch.equal(getattr(pstate, f), getattr(rstate, f)), f
    assert pstate.step == rstate.step == n
