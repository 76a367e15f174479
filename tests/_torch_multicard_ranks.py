"""The rank side of ``test_torch_multicard.py``: what a spawned gloo rank
imports first, kept light (the heavy imports come after ``os.nice``)."""

import os

WORLD = 4
TIMEOUT_S = 120
RUNS = (("1x4_blocking", (1, 4), False), ("4x1_overlap", (4, 1), True))
NAMELIST = """dtype = "float64"
backend = "pallas"
sim_days = 0.05
[grid]
nx = 32
ny = 24
nz = 8
[physics]
microphysics = true
radiation = true
surface = true
turbulence = true
rad_every_steps = 2
[numerics]
adaptive_dt = true
[sharding]
mesh_lat = 2
mesh_lon = 2
mode = "shard_map"
"""
BENCH_ARGV = ["bench", "--scaling", "--multihost", "--device", "cpu",
              "--steps", "2", "--halo-overlap"]


def mc_cfg(mesh=(2, 2), overlap=False):
    from climate_model_tpu_torch.core import config as tcfg
    phys = tcfg.PhysicsConfig(microphysics=True, radiation=True,
                              surface=True, turbulence=True,
                              rad_every_steps=2)
    return tcfg.ModelConfig(
        grid=tcfg.GridConfig(nx=32, ny=24, nz=8), physics=phys,
        numerics=tcfg.NumericsConfig(adaptive_dt=True),
        dtype="float64", backend="pallas", sim_days=0.05,
        out_every_hours=0.6,
        sharding=tcfg.ShardingConfig(mesh_lat=mesh[0], mesh_lon=mesh[1],
                                     mode="shard_map", halo_overlap=overlap))


def auto_cfg():
    """The plain backend's GSPMD auto mode on 2x2 (DTensors across ranks)."""
    import dataclasses
    cfg = mc_cfg()
    return cfg.replace(backend="jnp", sim_days=0.02,
                       sharding=dataclasses.replace(cfg.sharding,
                                                    mode="auto"))


def without_flip_and_roll():
    """DTensor as PyTorch 2.11 has it: no sharding strategy for aten.flip
    and aten.roll (the port then registers its own)."""
    import torch
    from torch.distributed.tensor import DTensor

    prop = DTensor._op_dispatcher.sharding_propagator
    for reg in ("op_strategy_funcs", "op_single_dim_strategy_funcs",
                "op_to_rules"):
        for op in (torch.ops.aten.flip.default, torch.ops.aten.roll.default):
            getattr(prop, reg, {}).pop(op, None)
    return prop


def rank_main(rank: int, port: int, out: str):
    # lowest priority, one thread and imports inside, as in
    # test_torch_dist_mp.py
    os.nice(19)
    import contextlib
    import io

    import torch

    from climate_model_tpu_torch import cli

    torch.set_num_threads(1)
    os.environ.update(MASTER_ADDR="localhost", MASTER_PORT=str(port),
                      RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank))
    with cli.multihost("cpu") as dev:
        for name, mesh, overlap in RUNS:
            res = cli.run(mc_cfg(mesh, overlap), device=dev,
                          out_dir=f"{out}/{name}", no_nc=True)
            fields = ("u", "v", "colp", "pott", "qv", "qc", "tsurf", "rain",
                      "soil_moist", "dpottdt_rad", "swflx_sfc", "lwflx_sfc",
                      "t")
            torch.save(dict(path=res.path, dts=res.dts, chunks=res.chunks,
                            step=res.state.step,
                            state={f: getattr(res.state, f) for f in fields}),
                       f"{out}/{name}.rank{rank}.pt")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = cli.main(BENCH_ARGV + ["--config", f"{out}/mesh.toml"])
        with open(f"{out}/bench.rank{rank}.txt", "w") as f:
            f.write(f"{rc}\n{buf.getvalue()}")
        prop = without_flip_and_roll()
        res = cli.run(auto_cfg(), device=dev)
        torch.save(dict(path=res.path, step=res.state.step,
                        own=[torch.ops.aten.flip.default
                             in prop.op_strategy_funcs,
                             torch.ops.aten.roll.default
                             in prop.op_strategy_funcs],
                        state={f: getattr(res.state, f) for f in fields}),
                   f"{out}/auto.rank{rank}.pt")
        # chip_smoke's planted fault of auto: each rank's columns rolled
        # within the rank
        import chip_smoke as cs
        (_, _, _, prims, _), = [x for x in cs.MC_PLAIN_FAULTS
                                if x[0] == "auto_fault"]
        with cs.planted(cs.bc, **prims):
            res = cli.run(auto_cfg(), device=dev)
        torch.save({f: getattr(res.state, f) for f in fields},
                   f"{out}/auto_fault.rank{rank}.pt")
