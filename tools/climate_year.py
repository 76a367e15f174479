"""A year over the continents against the reference's year.

Reads a run's ``metrics.jsonl`` of ``run --baseline 3 --topo continents
--days 365 --out-every-hours 6 --no-nc`` (run in legs with
``--auto-resume``; see README.md) and prints, beside the reference's
``out_clim_continents/metrics.jsonl``:

- whether the records form one timeline to day 365 (steps and days
  rising, no non-finite state);
- ``chip_smoke.py::annual_figures`` of both, and each figure of the run
  against the band pinned from the reference's series (``YEAR_BANDS``);
- the closure gate's readings over the year (``closure_residuals``), a
  reading beside the reference's, not a gate.

    python3 tools/climate_year.py out_torch_clim_continents/metrics.jsonl

Exits 1 if the timeline is broken or a figure is outside its band. Reads
files only: it runs on the CPU.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from climate_model_tpu_torch.core.config import baseline_config  # noqa: E402
from climate_model_tpu_torch.core.grid import make_grid  # noqa: E402

REFERENCE = os.path.join(ROOT, "out_clim_continents", "metrics.jsonl")
YEAR_DAYS = 365.0


def read_records(path: str) -> list:
    with open(path) as f:
        return [json.loads(line) for line in f]


def timeline_failures(records) -> list:
    """Why ``records`` are not one timeline from the start to the year's
    end: steps and days rising, every state finite, the last record within
    half a step of day 365."""
    bad = [f"record {i}: step {b['step']} / day {b['t_days']} does not rise"
           for i, (a, b) in enumerate(zip(records[:-1], records[1:]), 1)
           if not (b["step"] > a["step"] and b["t_days"] > a["t_days"])]
    bad += [f"step {r['step']}: non-finite state" for r in records
            if r["nan"]]
    last = records[-1]
    if abs(last["t_days"] - YEAR_DAYS) * 86400.0 > 0.5 * last["dt"]:
        bad.append(f"ends at day {last['t_days']}, not {YEAR_DAYS}")
    return bad


def main(argv) -> int:
    b3 = baseline_config(3)
    grid = make_grid(b3.grid, b3.numerics, dtype=torch.float64, device="cpu")
    area = cs.area_total(grid, b3.grid.nx)
    ref = read_records(REFERENCE)
    ref_fig = cs.annual_figures(ref)
    ref_cl = cs.closure_residuals(ref, area)
    ok = True
    for path in argv:
        recs = read_records(path)
        fails = timeline_failures(recs)
        if fails:
            print(f"{path}: not one timeline to day {YEAR_DAYS}")
            for f in fails:
                print(f"  FAIL {f}")
            ok = False
            continue
        fig = cs.annual_figures(recs)
        fails += cs.band_failures(fig, cs.YEAR_BANDS)
        cl = cs.closure_residuals(recs, area)
        print(f"{path}: {len(recs)} records, step {recs[-1]['step']} at day "
              f"{recs[-1]['t_days']:.6f} (the reference: {len(ref)}, step "
              f"{ref[-1]['step']} at day {ref[-1]['t_days']:.6f})")
        for k, v in fig.items():
            band = cs.YEAR_BANDS.get(k)
            print(f"  {k}: {v!r} / the reference's {ref_fig[k]!r}"
                  + (f"; band [{band[0]!r}, {band[1]!r}]" if band else ""))
        print(f"  closure over the year (a reading): mean residual "
              f"{cl['mean']:.4f} W/m2, max |{cl['max_abs']:.4f}|, water "
              f"{100 * cl['water_err']:.4f} % / the reference's "
              f"{ref_cl['mean']:.4f}, |{ref_cl['max_abs']:.4f}|, "
              f"{100 * ref_cl['water_err']:.4f} %")
        for f in fails:
            print(f"  FAIL {f}")
        ok = ok and not fails
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main(sys.argv[1:]))
