"""Run configuration (a copy of ``climate_model_tpu/core/config.py``).

The port keeps its own copy so that it never imports the JAX package; the
dataclasses and presets are field-for-field identical to the reference's
(``tests/test_torch_core.py`` holds them equal). Frozen, hashable dataclasses:
every switch is a host-side constant of the step functions built from them.
``backend='pallas'`` selects the fused substep kernel
(``kernels/fused_substep.py``, hand-written CUDA on the card), ``'jnp'`` the
plain PyTorch operators; the names are kept so configs cross unchanged.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class GridConfig:
    """Lat-lon-sigma grid extent. Mirrors reference namelist grid block.

    The domain spans ``lat0_deg..lat1_deg`` with rigid walls at both
    meridional boundaries (the reference's polar-row handling) and is
    periodic in longitude.
    """

    nx: int = 64                 # longitude cells
    ny: int = 32                 # latitude cells
    nz: int = 8                  # sigma levels
    lon0_deg: float = 0.0
    lon1_deg: float = 360.0
    lat0_deg: float = -80.0      # southern rigid wall
    lat1_deg: float = 80.0       # northern rigid wall
    ptop: float = 10_000.0       # pressure at model top [Pa]
    psurf: float = 101_350.0     # reference surface pressure [Pa]
    sigma_stretch: float = 1.0   # sigma-border power-law exponent; 1 = uniform
                                 # spacing, > 1 thins layers toward the top


@dataclasses.dataclass(frozen=True)
class PhysicsConfig:
    """Physics parameterization switches + parameters (reference ``i_*`` flags)."""

    microphysics: bool = False   # i_microphysics
    radiation: bool = False      # i_radiation
    surface: bool = False        # i_soil / i_surface
    turbulence: bool = False     # i_turbulence
    rad_every_steps: int = 6     # radiation substep interval (i_rad_nth_*)
    # Hour-based radiation cadence (the reference namelist's actual
    # ``i_rad_nth_hour`` unit): when > 0, ``resolve_rad_interval`` converts
    # it to rad_every_steps against the grid's CFL dt (the TOML loader and
    # the CLI do this automatically). 0 = use rad_every_steps directly.
    rad_every_hours: float = 0.0
    # Microphysics parameters. The autoconversion threshold is set LOW
    # (0.1 g/kg, round-4 retune): with no cloud-fraction scheme, qc below
    # the threshold is a permanent global stock (nothing drains it where
    # the column stays saturated), and at the old 0.5 g/kg that stock
    # reached a ~20 kg/m2 cloud-water path — a planet-wide LW blanket that
    # pinned OLR to cold cloud tops (see physics/radiation.py K_LW_QC
    # note). 0.1 g/kg keeps the standing cloud path at a few kg/m2.
    qc_autoconv_time: float = 1000.0   # cloud->rain conversion timescale [s]
    qc_autoconv_threshold: float = 1e-4  # cloud water threshold [kg/kg]
    # Turbulence parameters
    diff_coef_momentum: float = 1.0    # vertical eddy diffusivity K_m [m2 s-1]
    diff_coef_scalar: float = 1.0      # vertical eddy diffusivity K_h [m2 s-1]
    # Moist-convective mixing guard (round-4 stretch; flag-gated, default
    # OFF for reference parity — the reference has no convection scheme):
    # where a column is near-saturated and moist-unstable, the scalar
    # vertical diffusivity is raised to conv_diffusivity so the
    # instability mixes out instead of building a grid-point storm
    # (physics/turbulence.py::convective_k; the fused kernel's physics
    # epilogue carries the same math, so the flag works on BOTH backends).
    convection: bool = False
    conv_diffusivity: float = 100.0    # enhanced K_h on unstable interfaces
    conv_rh_crit: float = 0.95         # both layers this close to saturation
    # Surface parameters
    drag_coef: float = 1.3e-3          # bulk exchange coefficient C_H=C_E
    soil_heat_capacity: float = 2.0e6  # areal heat capacity [J m-2 K-1]
    # Slab-ocean areal heat capacity. 1e7 J m-2 K-1 ~ a 2.4 m mixed layer —
    # a deliberately shallow "swamp ocean" (round-4 retune) so the surface
    # relaxation time C/lambda is ~1 month and the milestone climatologies
    # actually reach TOA equilibrium on committable horizons (the r1-r3
    # value 2e8 = 50 m gave a ~2-year spin-up; deep-ocean heat uptake is
    # outside the reference's scope too). Diurnal SST amplitude at this
    # depth is ~0.5-1 K. Raise for realistic thermal inertia studies.
    ocean_heat_capacity: float = 1.0e7
    # Surface SW albedos CARRY THE PLANETARY ALBEDO (round-4 retune): the
    # gray shortwave has no cloud reflection, so the ~0.2 of cloud albedo a
    # real atmosphere provides must live in the surface values or the
    # planet absorbs ~330 W/m2 and can only balance at a runaway-hot state
    # (measured: the 0.08-ocean tune warmed monotonically through 337 K).
    # Same convention as published gray-radiation GCMs (uniform ~0.3);
    # split land/ocean to keep a land-sea contrast. Measured at the
    # equilibrated tuning (docs/STATUS.md round-4): planetary albedo ~0.26,
    # absorbed SW ~252 W/m2 -> emission temperature 258 K, a few K above
    # Earth's 255 (no SW cloud masking of the high-sun tropics here).
    albedo_land: float = 0.40
    albedo_ocean: float = 0.32
    evap_efficiency_land: float = 0.3
    solar_constant: float = 1365.0
    # Soil hydrology (reference ``soil_model.py`` [C/P]: prognostic soil
    # moisture fed by rain and depleted by evaporation, controlling the
    # land evaporation efficiency). Active when ``surface`` is on; set
    # False to fall back to the static Forcing.evap_eff map.
    soil_moisture: bool = True
    soil_moist_cap: float = 0.02     # field capacity [m liquid water]
    soil_moist_init: float = 0.01    # initial land soil water [m]
    # Ice/snow albedo (reference surface albedo raised where the surface
    # is frozen). Active when ``radiation`` is on.
    dynamic_albedo: bool = True
    albedo_ice: float = 0.5


@dataclasses.dataclass(frozen=True)
class NumericsConfig:
    """Time integration + per-tendency switches (reference ``i_*_tendency``)."""

    time_stepping: str = "matsuno"      # 'matsuno' | 'rk4' | 'euler'
    cfl: float = 0.7
    dt: Optional[float] = None          # fixed dt [s]; None -> derive from CFL at init
    # Reference solver.py recomputes dt every step from CFL and the current
    # max wind (SURVEY.md §3.1 hot loop #0). Rebuilt as a per-scan-chunk
    # recomputation on the host (the chunk diagnostics already fetch max
    # wind, so this costs no extra sync — §3.1 rebuild note); dt only
    # SHRINKS below the init value when winds exceed the 100 m/s init
    # margin (grid.adaptive_cfl_dt: the margin floor is load-bearing).
    # Works on BOTH backends: the fused kernel takes dt as a runtime SMEM
    # operand, so chunk-to-chunk dt changes never recompile (round 3).
    # Default False (tiny/test configs), but the production climatology
    # presets #3-#5 and annual_2deg.toml turn it ON (round 5 — see
    # baseline_config's docstring). A runtime-policy field: the checkpoint
    # identity excludes it, so fixed-dt checkpoints resume under adaptive
    # presets and vice versa (io/checkpoint.py _POLICY_FIELDS).
    adaptive_dt: bool = False
    wind_tendency: bool = True          # i_wind_tendency
    temperature_tendency: bool = True   # i_temperature_tendency
    colp_tendency: bool = True          # i_colp_tendency
    moisture_tendency: bool = True      # i_moisture_tendency
    # Horizontal diffusion (numerical smoothing, reference UVFLX_dif_coef /
    # POTT_hor_dif_tau analogues). Coefficients are diffusivities [m2 s-1]
    # applied as COLP-weighted 5-point Laplacians (docs/NUMERICS.md); the
    # production presets default them via ``default_diffusion`` below.
    diff_uv: float = 0.0
    diff_pott: float = 0.0
    diff_moist: float = 0.0


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """Device-mesh layout for 2-D lat-lon domain decomposition (SURVEY.md §5)."""

    mesh_lat: int = 1
    mesh_lon: int = 1
    mode: str = "auto"     # 'auto' (GSPMD jit) | 'shard_map' (explicit ppermute halos)
    halo_overlap: bool = False  # interior-compute/halo-comm overlap (shard_map mode)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Top-level config: everything static under jit, hashable."""

    grid: GridConfig = GridConfig()
    physics: PhysicsConfig = PhysicsConfig()
    numerics: NumericsConfig = NumericsConfig()
    sharding: ShardingConfig = ShardingConfig()
    dtype: str = "float32"              # working precision 'wp' of the reference
    backend: str = "jnp"                # 'jnp' | 'pallas' operator implementations
                                        # of the reference; the port always steps
                                        # through its kernels and keeps the field
                                        # so its configs equal the reference's
    # Topography/land configuration (round 5). Part of the ModelConfig — not
    # just an init argument — because forcing (hsurf/land/albedo) is REBUILT
    # from it on every start: a resume must agree with the checkpoint's
    # configuration or the state rides over the wrong mountains (the
    # checkpoint identity record carries both fields, so a forgotten
    # --topo on resume is refused instead of silently mis-forcing).
    topo: str = "gaussian_mountain"     # 'gaussian_mountain'|'aquaplanet'|
                                        # 'continents' (core/init.py)
    topo_file: Optional[str] = None     # NetCDF elevation file (io/topo.py);
                                        # overrides `topo` when set
    sim_days: float = 1.0
    out_every_hours: float = 6.0        # i_out_nth_hour
    restart_every_days: float = 1.0     # i_restart_nth_day

    def replace(self, **kw) -> "ModelConfig":
        return dataclasses.replace(self, **kw)


# ---------------------------------------------------------------------------
# The five BASELINE.md milestone configs as presets.
# ---------------------------------------------------------------------------

def default_diffusion(nx: int) -> float:
    """Scale-aware horizontal-diffusion coefficient [m2 s-1] for the moist/
    full-physics presets: K = 1e5 * (dx_eq / 111 km)^2, i.e. the damping
    timescale of 2*dx noise is resolution-invariant (~4 h at the equator,
    minutes at the polar rows where dx shrinks). The reference ships its
    standard namelist WITH horizontal diffusion (wind.py UVFLX_dif_coef,
    temperature.py POTT_hor_dif_tau — SURVEY.md §2.1 rows 8-9 [P]); round-2
    shipped the coefficients defaulted to 0, which left production grids
    running without the smoothing the reference always applies (VERDICT r2
    missing #1). Explicit-stability check: K*dt*4/dx_pole^2 ~ 0.04 at 1 deg.
    """
    dx_eq_1deg = 111.0e3                       # 1-deg equatorial spacing [m]
    dx_eq = dx_eq_1deg * 360.0 / nx
    return 1.0e5 * (dx_eq / dx_eq_1deg) ** 2


def resolve_rad_interval(cfg: "ModelConfig") -> "ModelConfig":
    """Convert ``PhysicsConfig.rad_every_hours`` (the reference namelist's
    ``i_rad_nth_hour`` unit) into ``rad_every_steps`` against the grid's
    actual timestep. Idempotent (recomputes from the hour value each call);
    a no-op when the knob is unset. The TOML loader and CLI call this, so a
    namelist ported from the reference needs no manual dt arithmetic. With
    --adaptive-dt the cadence stays step-based from the INIT dt (adaptive
    dt only shrinks the step, so the wall-time cadence only tightens)."""
    phys = cfg.physics
    if not (phys.radiation and phys.rad_every_hours > 0):
        return cfg
    from .grid import make_grid          # deferred: grid imports config
    dt = float(make_grid(cfg.grid, cfg.numerics, np_mode=True).dt)
    steps = max(1, round(phys.rad_every_hours * 3600.0 / dt))
    return cfg.replace(
        physics=dataclasses.replace(phys, rad_every_steps=steps))


def check_rad_resolved(cfg: "ModelConfig") -> None:
    """Guard for programmatic entry points (ADVICE r3): ``rad_every_hours``
    is config-surface sugar that ``resolve_rad_interval`` folds into
    ``rad_every_steps`` (the TOML loader and CLI do this automatically). A
    ModelConfig built in Python with the hour knob set but never resolved
    would silently run at the step default — and the checkpoint fingerprint
    (which drops the sugar field) would not flag it. Every step-function constructor
    calls this; it raises instead of resolving silently so the config the
    caller fingerprints/saves is the config that actually ran."""
    phys = cfg.physics
    if phys.radiation and phys.rad_every_hours > 0:
        if resolve_rad_interval(cfg).physics.rad_every_steps \
                != phys.rad_every_steps:
            raise ValueError(
                "rad_every_hours is set but unresolved: pass the config "
                "through core.config.resolve_rad_interval(cfg) before "
                "building the model (the TOML loader and CLI do this)")


def _diffused_numerics(nx: int, **kw) -> NumericsConfig:
    k = default_diffusion(nx)
    return NumericsConfig(diff_uv=k, diff_pott=k, diff_moist=k, **kw)


def baseline_config(n: int) -> ModelConfig:
    """Milestone configs #1..#5 from BASELINE.md.

    The full-physics presets (#3-#5) run radiation on the reference's
    HOURLY cadence (``i_rad_nth_hour`` = 1; round-4 — the r1-r3 default of
    every 6 steps ~ 3.4 sim-minutes was far more frequent than reference
    parity and cost a measured ~3%). Returned configs are already passed
    through ``resolve_rad_interval`` (hours -> steps against the CFL dt).

    They also run with ADAPTIVE dt (round 5, VERDICT r4 weak #1): the
    committed year-long 1-deg run saw transient 204 m/s NH-winter jets —
    1.25x past the +100 m/s design margin, ~2% from the measured ~1.27x
    blow-up boundary (docs/STATUS.md round-3 addendum). ``adaptive_dt``
    re-evaluates dt per scan chunk from the measured max wind and only
    SHRINKS it below the init value (grid.adaptive_cfl_dt margin floor),
    which is exactly the safety role the reference's per-step dt recompute
    plays (SURVEY.md §3.1). Measured perf-neutral on v5e (dt is a runtime
    SMEM operand of the fused kernel — no recompiles).
    """
    if n == 1:    # dry core, coarse, 100 steps, CPU allclose gate
        return ModelConfig(
            grid=GridConfig(nx=64, ny=32, nz=8),
            physics=PhysicsConfig(),
            numerics=NumericsConfig(moisture_tendency=False),
        )
    full_phys = dict(microphysics=True, radiation=True, surface=True,
                     turbulence=True, rad_every_hours=1.0)
    if n == 2:    # moist core at 1.5 deg, 500 steps
        return ModelConfig(
            grid=GridConfig(nx=240, ny=120, nz=16),
            physics=PhysicsConfig(microphysics=True),
            numerics=_diffused_numerics(240),
        )
    if n == 3:    # full physics at 1 deg, single chip
        return resolve_rad_interval(ModelConfig(
            grid=GridConfig(nx=360, ny=180, nz=32),
            physics=PhysicsConfig(**full_phys),
            numerics=_diffused_numerics(360, adaptive_dt=True),
            backend="pallas",
        ))
    if n == 4:    # 0.5 deg, multi-host domain decomposition
        return resolve_rad_interval(ModelConfig(
            grid=GridConfig(nx=720, ny=360, nz=32),
            physics=PhysicsConfig(**full_phys),
            numerics=_diffused_numerics(720, adaptive_dt=True),
            sharding=ShardingConfig(mesh_lat=2, mesh_lon=4, mode="shard_map"),
            backend="pallas",
        ))
    if n == 5:    # 0.25 deg climatology
        return resolve_rad_interval(ModelConfig(
            grid=GridConfig(nx=1440, ny=720, nz=32),
            physics=PhysicsConfig(**full_phys),
            numerics=_diffused_numerics(1440, adaptive_dt=True),
            sharding=ShardingConfig(mesh_lat=4, mesh_lon=8, mode="shard_map"),
            sim_days=5.0,
            backend="pallas",
        ))
    raise ValueError(f"unknown baseline config {n}")
