"""TOML namelist layer.

Port of ``climate_model_tpu/core/namelist.py``: a TOML file of the config's
sections loaded into the frozen dataclass config, with the hour-based
radiation cadence resolved against the grid's dt. Unknown keys are
rejected.

Example (configs/baseline_1.toml):

    [grid]
    nx = 64
    ny = 32
    nz = 8

    [physics]
    microphysics = false

    [numerics]
    time_stepping = "matsuno"
"""

from __future__ import annotations

import dataclasses
import tomllib

from .config import (GridConfig, ModelConfig, NumericsConfig, PhysicsConfig,
                     ShardingConfig, resolve_rad_interval)

_SECTIONS = {
    "grid": GridConfig,
    "physics": PhysicsConfig,
    "numerics": NumericsConfig,
    "sharding": ShardingConfig,
}


def config_from_dict(data: dict) -> ModelConfig:
    kw = {}
    for section, cls in _SECTIONS.items():
        if section in data:
            body = data.pop(section)
            valid = {f.name for f in dataclasses.fields(cls)}
            unknown = set(body) - valid
            if unknown:
                raise ValueError(
                    f"unknown keys in [{section}]: {sorted(unknown)}; "
                    f"valid: {sorted(valid)}")
            kw[section] = cls(**body)
    valid_top = {f.name for f in dataclasses.fields(ModelConfig)}
    unknown = set(data) - valid_top
    if unknown:
        raise ValueError(f"unknown top-level keys: {sorted(unknown)}; "
                         f"valid: {sorted(valid_top)}")
    kw.update(data)
    return resolve_rad_interval(ModelConfig(**kw))


def load_config(path: str) -> ModelConfig:
    with open(path, "rb") as f:
        data = tomllib.load(f)
    return config_from_dict(data)
