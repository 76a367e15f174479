"""The corrector with the physics epilogue (surface, turbulence and
microphysics in the corrector call) against the reference's Pallas kernel
in interpret mode (CPU, fp64).

The port's ``corrector(..., phys=..., vmask=...)`` on CPU tensors is its
plain version: the plain substep, then the port's surface, turbulence and
microphysics splits. The reference is ``make_fused_substep_packed(...,
same_base=False, phys=..., wall_mask=True, interpret=True)`` on inputs
packed by the JAX package's own helpers. Inputs are made from a seed with
numpy so that every term is active: near-saturated columns (condensation,
evaporation of cloud, autoconversion, convective mixing), land and ocean,
a soil bucket between dry and field capacity, nonzero surface radiation.

Tolerance rtol=atol=1e-10, as for the reference kernel against its own jnp
operators (``tests/unit/test_pallas_substep.py``).
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_model_tpu import model as jmodel
from climate_model_tpu.core import grid as jgrid
from climate_model_tpu.kernels.fused_substep import (GEO_FIELDS,
                                                     make_fused_substep_packed,
                                                     make_vert, pack_geo,
                                                     pack_prog, pack_radf,
                                                     unpack_prog)
from climate_model_tpu.kernels.packing import pack_aux
from climate_model_tpu_torch import model as tmodel
from climate_model_tpu_torch.core.config import NumericsConfig, PhysicsConfig
from climate_model_tpu_torch.dycore.operators import diagnose_pressure
from climate_model_tpu_torch.kernels import fused_substep as fs
from climate_model_tpu_torch.physics.thermo import qsat_water

from .test_torch_core import jax_cfg, jax_inputs, port_inputs, small_cfg

from ._torch_threads import torch_threads  # noqa: F401 (fixture)

TOL = dict(rtol=1e-10, atol=1e-10)
OUT = ("u", "v", "pott", "qv", "qc", "colp", "tsurf", "rain", "soil_moist")

FLAG_SETS = {
    "all": {},
    "surface_only": dict(turbulence=False, microphysics=False),
    "turbulence_only": dict(surface=False, microphysics=False),
    "microphysics_only": dict(surface=False, turbulence=False),
    "soil_off": dict(soil_moisture=False),
    "convection_on": dict(convection=True),
}
# (nx, ny, nz, bj): bj = 4 does not divide ny = 10
SHAPES = [(32, 16, 8, 8), (16, 10, 4, 4)]


def make_inputs(nx, ny, nz, flags, seed=11):
    """Config, port State/Forcing/Grid (fp64, CPU) and the reference's grid,
    with the physics inputs perturbed so that every term is active."""
    cfg = small_cfg(nx=nx, ny=ny, nz=nz,
                    numerics=NumericsConfig(diff_uv=5e4, diff_pott=5e4,
                                            diff_moist=2e4),
                    physics=PhysicsConfig(**{
                        "radiation": True, "surface": True,
                        "turbulence": True, "microphysics": True, **flags}))
    st, fo, g = jax_inputs(cfg, seed=seed)
    st["step"] = np.asarray(0, np.int32)
    r = np.random.default_rng(seed + 1)
    s2 = st["colp"].shape
    # moisture near saturation: relative humidity 0.8-1.2 of the Magnus
    # saturation at each level, cloud water around the autoconversion
    # threshold
    state, _, grid = port_inputs(st, fo, g)
    pvb, pvtf, _ = (x.numpy() for x in diagnose_pressure(state.colp, grid))
    tair = st["pott"] * pvtf
    qs = qsat_water(tair, 0.5 * (pvb[:-1] + pvb[1:]), xp=np)
    st["qv"] = qs * r.uniform(0.8, 1.2, qs.shape)
    st["qc"] = np.abs(r.normal(0.0, 2e-4, qs.shape))
    st["tsurf"] = st["tsurf"] + r.normal(0.0, 5.0, s2)
    st["soil_moist"] = r.uniform(0.0, cfg.physics.soil_moist_cap, s2)
    st["rain"] = r.uniform(0.0, 1.0, s2)
    st["swflx_sfc"] = r.uniform(0.0, 400.0, s2)
    st["lwflx_sfc"] = r.uniform(-120.0, 0.0, s2)
    fo["land_mask"] = (r.uniform(size=s2) < 0.4).astype(np.float64)
    fo["evap_eff"] = r.uniform(0.2, 1.0, s2)
    jc = jax_cfg(cfg)
    jg = jgrid.make_grid(jc.grid, jc.numerics, dtype=jnp.float64)
    return cfg, port_inputs(st, fo, g), fo, jg


def jax_epilogue_corrector(cfg, ev, base, forcing_np, jg, bj):
    """The reference's corrector with the physics epilogue and the wall
    mask, on the JAX package's packed layout, unpacked to the State
    fields (order ``OUT``)."""
    nz, ny, nx = ev.u.shape
    f = lambda t: jnp.asarray(t.numpy())
    prog_ev = pack_prog(*(f(getattr(ev, n)) for n in OUT[:6]),
                        f(base.tsurf), f(base.rain), f(base.soil_moist), bj)
    prog_base = pack_prog(*(f(getattr(base, n)) for n in OUT), bj)
    radf = pack_radf(f(base.swflx_sfc), f(base.lwflx_sfc),
                     f(ev.dpottdt_rad), bj)
    forcing = types.SimpleNamespace(
        **{k: jnp.asarray(v) for k, v in forcing_np.items()})
    aux2 = pack_aux(forcing, jg, bj, jnp.float64).aux2      # + the wall mask
    geo = pack_geo(jnp.stack([getattr(jg, n) for n in GEO_FIELDS], axis=1),
                   bj)
    vert = make_vert(jg.sigma_vb, jg.dsigma, jnp.float64)
    kern = make_fused_substep_packed(
        nz, ny, nx, bj=bj, same_base=False, dy=float(jg.dy), ptop=jg.ptop,
        with_rad=True, with_diff=True, dtype=jnp.float64, interpret=True,
        phys=jmodel.phys_epilogue_tuple(jax_cfg(cfg)), wall_mask=True)
    out = kern(prog_ev, prog_base, radf, aux2, geo, vert, float(jg.dt))
    return dict(zip(OUT, (np.asarray(x) for x in unpack_prog(out, nz, ny,
                                                               nx))))


@pytest.mark.parametrize("flags", list(FLAG_SETS), ids=list(FLAG_SETS))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_epilogue_matches_pallas_interpret(shape, flags):
    nx, ny, nz, bj = shape
    cfg, (base, forcing, grid), fo, jg = make_inputs(nx, ny, nz,
                                                     FLAG_SETS[flags])
    phys = tmodel.phys_epilogue_tuple(cfg)
    assert phys == jmodel.phys_epilogue_tuple(jax_cfg(cfg))
    kw = dict(with_rad=True, with_diff=True)
    vmask = fs.wall_mask(ny, torch.float64, "cpu")
    ev = fs.predictor(base, grid, forcing, grid.dt, vmask=vmask, **kw)
    got = fs.corrector(ev, base, grid, forcing, grid.dt, phys=phys,
                       vmask=vmask, **kw)
    want = jax_epilogue_corrector(cfg, ev, base, fo, jg, bj)
    for name in OUT:
        np.testing.assert_allclose(getattr(got, name).numpy(), want[name],
                                   err_msg=name, **TOL)
    # the physics changed what it should: tsurf with the surface on, rain
    # with the microphysics on
    p = dict(zip(fs.PHYS_FIELDS, phys))
    assert p["surface"] == (not np.array_equal(want["tsurf"],
                                               base.tsurf.numpy()))
    assert p["microphysics"] == (not np.array_equal(want["rain"],
                                                    base.rain.numpy()))


@pytest.mark.parametrize("flags", ["all", "convection_on"])
def test_epilogue_tall_column_matches_pallas_interpret(flags):
    """80 levels, more than one warp's 32 lanes (the epilogue kernel holds
    three levels a lane on the card): the plain version against the
    reference kernel."""
    nz = 80
    assert 32 < nz <= fs.MAX_NZ
    test_epilogue_matches_pallas_interpret((16, 10, nz, 4), flags)
