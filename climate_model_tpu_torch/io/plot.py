"""Quicklook plots.

A copy of ``climate_model_tpu/io/plot.py``, so that the port never imports
the JAX package: multi-panel PNGs from an output NetCDF file, a restart
checkpoint (maps or zonal means) or a run's ``metrics.jsonl`` (time
series). ``matplotlib`` is imported inside the functions that render; where
it is missing they raise its ``ImportError``.
"""

from __future__ import annotations

import numpy as np


def quicklook_nc(nc_path: str, png_path: str, level: int = -1) -> str:
    """Render a quicklook PNG from an out_XXXX.nc file."""
    from scipy.io import netcdf_file

    with netcdf_file(nc_path, "r", mmap=False) as f:
        u = np.asarray(f.variables["UWIND"][0])
        v = np.asarray(f.variables["VWIND"][0])
        tair = np.asarray(f.variables["TAIR"][0])
        qv = np.asarray(f.variables["QV"][0])
        psurf = np.asarray(f.variables["PSURF"][0])
        rain = np.asarray(f.variables["RAIN"][0])
        t_days = float(np.asarray(f.variables["time"][0]))
        coords = None
        if "lat" in f.variables:       # coordinate vars (older files lack them)
            coords = (np.asarray(f.variables["lon"][:]).copy(),
                      np.asarray(f.variables["lat"][:]).copy())
    return _render(u, v, tair, qv, psurf, rain, t_days, png_path, level,
                   coords=coords)


def quicklook_npz(npz_path: str, png_path: str, level: int = -1,
                  grid_cfg=None) -> str:
    """Render a quicklook PNG straight from a restart checkpoint
    (``--no-nc`` runs keep metrics + restarts only — e.g. when the
    device->host link is too slow for field dumps). The temperature panel
    shows POTT (computing TAIR would need the sigma/Exner geometry that a
    State-only checkpoint does not carry). Pass the run's ``GridConfig``
    (CLI ``--baseline``/``--config``) for the correct ptop and lat/lon
    extents; defaults assume the standard domain."""
    ptop = grid_cfg.ptop if grid_cfg is not None else 10_000.0
    with np.load(npz_path) as z:
        u, v, pott, qv = z["u"], z["v"], z["pott"], z["qv"]
        psurf = z["colp"] + ptop
        rain = z["rain"]
        t_days = float(z["t"]) / 86400.0
    coords = None
    if grid_cfg is not None:
        ny, nx = psurf.shape
        coords = (np.linspace(grid_cfg.lon0_deg, grid_cfg.lon1_deg, nx,
                              endpoint=False),
                  np.linspace(grid_cfg.lat0_deg, grid_cfg.lat1_deg, ny))
    return _render(u, v, pott, qv, psurf, rain, t_days, png_path, level,
                   temp_name="POTT", coords=coords)


def _render(u, v, tair, qv, psurf, rain, t_days, png_path, level=-1,
            temp_name="TAIR", coords=None) -> str:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, axes = plt.subplots(2, 2, figsize=(13, 7), constrained_layout=True)
    ny, nx = psurf.shape
    if coords is not None:
        lon, lat = coords
    else:   # standard-domain fallback (legacy files without coordinates)
        lon = np.linspace(0, 360, nx, endpoint=False)
        lat = np.linspace(-80, 80, ny)

    ax = axes[0, 0]
    m = ax.pcolormesh(lon, lat, psurf / 100.0, cmap="viridis", shading="auto")
    sub = max(nx // 36, 1)
    ax.quiver(lon[::sub], lat[::sub], u[level][::sub, ::sub],
              v[level][::sub, ::sub], color="white", scale=400)
    fig.colorbar(m, ax=ax, label="hPa")
    ax.set_title(f"PSURF + wind (level {level}), day {t_days:.2f}")

    ax = axes[0, 1]
    m = ax.pcolormesh(lon, lat, tair[level], cmap="RdYlBu_r", shading="auto")
    fig.colorbar(m, ax=ax, label="K")
    ax.set_title(temp_name)

    ax = axes[1, 0]
    m = ax.pcolormesh(lon, lat, 1e3 * qv[level], cmap="Blues", shading="auto")
    fig.colorbar(m, ax=ax, label="g/kg")
    ax.set_title("QV")

    ax = axes[1, 1]
    m = ax.pcolormesh(lon, lat, rain, cmap="GnBu", shading="auto")
    fig.colorbar(m, ax=ax, label="kg/m$^2$")
    ax.set_title("accumulated RAIN")

    for ax in axes.flat:
        ax.set_xlabel("lon")
        ax.set_ylabel("lat")
    fig.savefig(png_path, dpi=110)
    plt.close(fig)
    return png_path


def zonal_mean_npz(npz_path: str, png_path: str, grid_cfg=None) -> str:
    """Zonal-mean climatology cross-sections from a restart checkpoint —
    the classic GCM evaluation figure: u(lat, sigma) jet structure,
    temperature, specific humidity, plus zonal-mean surface temperature
    and accumulated rain. (CLI: ``plot <restart.npz> --zonal``.)"""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    from ..core import constants as c

    ptop = grid_cfg.ptop if grid_cfg is not None else 10_000.0
    with np.load(npz_path) as z:
        u, pott, qv = z["u"], z["pott"], z["qv"]
        colp, tsurf, rain = z["colp"], z["tsurf"], z["rain"]
        t_days = float(z["t"]) / 86400.0
    nz, ny, nx = u.shape
    lat = (np.linspace(grid_cfg.lat0_deg, grid_cfg.lat1_deg, ny)
           if grid_cfg is not None else np.linspace(-80, 80, ny))
    sig = (np.arange(nz) + 0.5) / nz
    pair = ptop + sig[:, None] * colp.mean(axis=1)[None, :]     # (nz, ny)
    tair = pott.mean(axis=2) * (pair / c.P_REF) ** c.KAPPA

    fig, axes = plt.subplots(2, 2, figsize=(13, 7), constrained_layout=True)
    panels = [
        (u.mean(axis=2), "zonal-mean U [m/s]", "RdBu_r", True),
        (tair, "zonal-mean TAIR [K]", "RdYlBu_r", False),
        (1e3 * qv.mean(axis=2), "zonal-mean QV [g/kg]", "Blues", False),
    ]
    for ax, (fld, title, cmap, sym) in zip(axes.flat[:3], panels):
        kw = {}
        if sym:
            vmax = np.abs(fld).max()
            kw = dict(vmin=-vmax, vmax=vmax)
        m = ax.pcolormesh(lat, sig, fld, cmap=cmap, shading="auto", **kw)
        fig.colorbar(m, ax=ax)
        ax.invert_yaxis()                       # sigma: surface at bottom
        ax.set_title(f"{title}, day {t_days:.1f}")
        ax.set_xlabel("lat")
        ax.set_ylabel("sigma")
    ax = axes[1, 1]
    ax.plot(lat, tsurf.mean(axis=1), color="tab:red", label="TSURF [K]")
    ax.set_ylabel("TSURF [K]", color="tab:red")
    ax2 = ax.twinx()
    ax2.plot(lat, rain.mean(axis=1), color="tab:blue",
             label="accum. RAIN")
    ax2.set_ylabel("accum. RAIN [kg/m$^2$]", color="tab:blue")
    ax.set_title("zonal-mean surface state")
    ax.set_xlabel("lat")
    fig.savefig(png_path, dpi=110)
    plt.close(fig)
    return png_path


def timeseries_jsonl(metrics_path: str, png_path: str) -> str:
    """Climate time series from a run's ``metrics.jsonl`` — the
    equilibration / annual-cycle figure: mean POTT + precipitable water,
    TOA budget (absorbed SW vs OLR), and the hydrologic cycle (rain rate
    vs evaporation). (CLI: ``plot <metrics.jsonl>``.)"""
    import json

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    recs = [json.loads(l) for l in open(metrics_path) if l.strip()]
    t = np.array([r["t_days"] for r in recs])
    get = lambda k: np.array([r.get(k, 0.0) for r in recs])

    fig, axes = plt.subplots(3, 1, figsize=(10, 9), sharex=True,
                             constrained_layout=True)
    ax = axes[0]
    ax.plot(t, get("mean_pott"), color="tab:red")
    ax.set_ylabel("mass-weighted POTT [K]", color="tab:red")
    if "pw" in recs[-1]:
        ax2 = ax.twinx()
        ax2.plot(t, get("pw"), color="tab:blue")
        ax2.set_ylabel("precipitable water [kg/m$^2$]", color="tab:blue")
    ax.set_title("atmospheric state")

    ax = axes[1]
    ax.plot(t, get("toa_net_sw"), label="absorbed SW", color="tab:orange")
    ax.plot(t, get("olr"), label="OLR", color="tab:purple")
    ax.plot(t, get("toa_net_sw") - get("olr"), label="imbalance",
            color="tab:gray")
    ax.axhline(0.0, color="k", lw=0.5)
    ax.set_ylabel("W/m$^2$")
    ax.legend(loc="center right")
    ax.set_title("TOA budget")

    ax = axes[2]
    rain = get("total_rain")
    # centered rain rate from the accumulated series (zero for a
    # single-chunk file — no interval to difference)
    rr = (np.gradient(rain, t, edge_order=1) if len(t) > 1
          else np.zeros_like(rain))
    ax.plot(t, rr, label="rain rate", color="tab:blue")
    ax.plot(t, get("evap_rate") * 86400.0, label="evaporation",
            color="tab:green")
    ax.set_ylabel("mm/day")
    ax.set_xlabel("sim day")
    ax.legend(loc="lower right")
    ax.set_title("hydrologic cycle")
    fig.savefig(png_path, dpi=110)
    plt.close(fig)
    return png_path
