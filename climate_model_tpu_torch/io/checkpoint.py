"""Checkpoint and restart.

Port of ``climate_model_tpu/io/checkpoint.py``, in the same file format both
ways, so that either package resumes from the other's files:

* an ``npz`` keyed by the ``State`` field names, ``step`` a 0-d ``int32``,
  ``t`` at the state's dtype;
* ``_fingerprint`` (a short hash, for display) and ``_config_json`` (the
  full identity record) as ``uint8`` buffers;
* written to a temporary file and moved into place (``os.replace``), so a
  crash never leaves half a checkpoint under the real name;
* across ``torch.distributed`` ranks, one file per rank, ``path.p{rank}``,
  holding its shard's interior under ``name@start0,start1[,start2]`` keys
  of global offsets; a save returns once every rank has written its file,
  so that a load that follows on any rank finds the whole set. The loader
  reassembles a ``.p*`` set and checks that it covers every field and that
  its files hold one step.

A load compares the saved identity record with the current config field by
field, over the fields present in both records, refuses a mismatch naming
the fields, and with ``force=True`` warns once and returns the mismatch
record. Files of the reference that carry only its legacy ``_fingerprint``
hash (no ``_config_json``) are refused: the port has no legacy-hash path.
"""

from __future__ import annotations

import dataclasses
import glob
import hashlib
import json
import os

import numpy as np
import torch

from ..core.config import ModelConfig
from ..core.state import State, resolve_device
from ..dist.mesh import barrier
from ..dist.sharding import STATE_FIELDS, ShardedState, gather, interior
from ..trace import span
from .convert import state_from_numpy, state_to_numpy

# Fields that select a runtime policy rather than the state's identity (the
# reference's ``_POLICY_FIELDS``): ``rad_every_hours`` is folded into
# ``rad_every_steps`` before anything runs, and adaptive dt only shrinks dt
# below its initial value, so resuming under either setting is a
# continuation.
_POLICY_FIELDS = {
    "physics": ("rad_every_hours",),
    "numerics": ("adaptive_dt",),
}
_RECORDS = ("_fingerprint", "_config_json")


def _all_fields(obj, drop=()) -> dict:
    return {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)
            if f.name not in drop}


def config_identity(cfg: ModelConfig) -> dict:
    """The full values of the config sections that define the state's shape
    and meaning (grid, physics, numerics, dtype, topography), without run
    length, output cadence, device layout or backend, and without the
    policy fields. Round-tripped through JSON so that saved and current
    records compare exactly."""
    ident = dict(
        grid=_all_fields(cfg.grid),
        physics=_all_fields(cfg.physics, drop=_POLICY_FIELDS["physics"]),
        numerics=_all_fields(cfg.numerics, drop=_POLICY_FIELDS["numerics"]),
        dtype=cfg.dtype, topo=cfg.topo, topo_file=cfg.topo_file)
    return json.loads(json.dumps(ident, sort_keys=True, default=str))


def config_fingerprint(cfg: ModelConfig) -> str:
    """Short hash of ``config_identity``, for display; a load compares the
    full record."""
    blob = json.dumps(config_identity(cfg), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def _shard_leaves(ss) -> dict:
    """This rank's shard interiors under ``name@offsets`` keys; ``t`` and
    ``step`` (the same on every rank) under their names."""
    (st,), (lay,) = ss.states, ss.layouts
    leaves = {}
    for f in dataclasses.fields(State):
        if f.name not in STATE_FIELDS:
            continue
        x = interior(getattr(st, f.name), lay)
        starts = (0,) * (x.dim() - 2) + (lay.lat_idx * lay.ny_l,
                                         lay.lon_idx * lay.nx_l)
        key = f.name + "@" + ",".join(str(s) for s in starts)
        leaves[key] = x.detach().cpu().numpy()
    leaves["t"] = st.t.detach().cpu().numpy()
    leaves["step"] = np.asarray(st.step, np.int32)
    return leaves


def save_checkpoint(path: str, state, cfg: ModelConfig):
    """Write ``state`` and the identity record of ``cfg`` to ``path``.

    ``state`` is a ``State``, or a ``dist.sharding.ShardedState``: with one
    shard per ``torch.distributed`` rank each rank writes its interior to
    ``path.p{rank}`` and waits for the others at a barrier; with every
    shard in this process the state is gathered and written as one
    file. The span ``cm.output.checkpoint`` holds the copy to the host
    (``.fetch``) and the file (``.write``)."""
    with span("output.checkpoint"):
        _save(path, state, cfg)


def _save(path: str, state, cfg: ModelConfig):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    ranks = isinstance(state, ShardedState) and state.mesh.distributed
    with span("output.checkpoint.fetch"):
        if ranks:
            path = f"{path}.p{state.mesh.rank}"
            leaves = _shard_leaves(state)
        else:
            if isinstance(state, ShardedState):
                state = gather(state)
            leaves = state_to_numpy(state)
    leaves["_fingerprint"] = np.frombuffer(
        config_fingerprint(cfg).encode(), dtype=np.uint8)
    leaves["_config_json"] = np.frombuffer(
        json.dumps(config_identity(cfg), sort_keys=True).encode(),
        dtype=np.uint8)
    with span("output.checkpoint.write"):
        tmp = path + ".tmp.npz"   # np.savez appends .npz unless present
        np.savez(tmp, **leaves)
        os.replace(tmp, path)
    if ranks:
        barrier(state.states[0].device)


def _config_mismatch(z, cfg: ModelConfig, where: str):
    """None if the saved record agrees with ``cfg``; else ``{"section.field":
    {"saved": v, "current": v}}`` for every field present in both records
    that differs."""
    if "_config_json" not in z.files:
        raise ValueError(
            f"checkpoint {where}: a legacy checkpoint of the reference "
            "(identity hash only, no _config_json record); the port does "
            "not read legacy checkpoints")
    saved = json.loads(bytes(z["_config_json"]).decode())
    cur = config_identity(cfg)
    diffs = {}
    for sec, body in saved.items():
        if not isinstance(body, dict):           # dtype, topo, topo_file
            if body != cur.get(sec):
                diffs[sec] = dict(saved=body, current=cur.get(sec))
            continue
        for name, v in body.items():
            if sec in cur and name in cur[sec] and v != cur[sec][name]:
                diffs[f"{sec}.{name}"] = dict(saved=v, current=cur[sec][name])
    return diffs or None


def _check(z, where: str, cfg: ModelConfig, force: bool):
    mm = _config_mismatch(z, cfg, where)
    if mm is None:
        return None
    if not force:
        fields = ", ".join(f"{k}: saved {v['saved']!r} != current "
                           f"{v['current']!r}" for k, v in mm.items())
        raise ValueError(
            f"checkpoint {where}: config mismatch ({fields}); refusing to "
            "resume with a different configuration (pass --force-resume "
            "to branch a perturbation experiment from this state on "
            "purpose)")
    print(f"WARNING: {where}: config mismatch ({', '.join(sorted(mm))}); "
          "resuming anyway (--force-resume: branched experiment)",
          flush=True)
    return mm


def _reassemble(shard_files: list, cfg: ModelConfig, force: bool):
    """The global arrays of a ``.p*`` set, and its mismatch record (checked
    on every file, reported once)."""
    pieces: dict = {}
    mismatch = None
    for pf in shard_files:
        with np.load(pf) as z:
            if mismatch is None:
                mismatch = _check(z, pf, cfg, force)
            for key in z.files:
                if key in _RECORDS:
                    continue
                name, _, off = key.partition("@")
                starts = (tuple(int(x) for x in off.split(","))
                          if off else ())
                pieces.setdefault(name, []).append((starts, z[key]))
    arrays = {}
    for f in dataclasses.fields(State):
        if f.name not in pieces:
            raise ValueError(f"checkpoint shard files miss field {f.name!r}")
        parts = pieces[f.name]
        if parts[0][0] == ():                      # replicated scalar
            if any(not np.array_equal(a, parts[0][1]) for _, a in parts):
                raise ValueError(
                    f"checkpoint shard files disagree on {f.name!r} "
                    f"({sorted(float(a) for _, a in parts)}): files of "
                    "different saves?")
            arrays[f.name] = parts[0][1]
            continue
        nd = parts[0][1].ndim
        shape = tuple(max(st[d] + a.shape[d] for st, a in parts)
                      for d in range(nd))
        full = np.empty(shape, parts[0][1].dtype)
        seen = np.zeros(shape, bool)
        for st, a in parts:
            idx = tuple(slice(s, s + n) for s, n in zip(st, a.shape))
            full[idx] = a
            seen[idx] = True
        if not seen.all():
            raise ValueError(
                f"checkpoint shard files do not cover field {f.name!r} "
                f"(global shape {shape}); incomplete save?")
        arrays[f.name] = full
    return arrays, mismatch


def load_checkpoint_ex(path: str, cfg: ModelConfig, force: bool = False,
                       device="cuda"):
    """Bit-exact resume: ``(state, mismatch)``, the state's tensors at the
    file's dtype on ``device``; ``mismatch`` is None for a clean load, else
    the record of the fields that differ (only with ``force=True``; without
    it a mismatch raises). Reads a single file at ``path`` or a ``.p*`` set
    written across ranks."""
    dev = resolve_device(device)
    if os.path.exists(path):
        with np.load(path) as z:
            mismatch = _check(z, path, cfg, force)
            arrays = {f.name: z[f.name] for f in dataclasses.fields(State)}
    else:
        shard_files = sorted(f for f in glob.glob(path + ".p*")
                             if not f.endswith(".tmp.npz"))
        if not shard_files:
            raise FileNotFoundError(
                f"no checkpoint at {path} (nor shard files {path}.p*)")
        arrays, mismatch = _reassemble(shard_files, cfg, force)
    dtype = getattr(torch, str(arrays["u"].dtype))
    return state_from_numpy(arrays, device=dev, dtype=dtype), mismatch


def load_checkpoint(path: str, cfg: ModelConfig, force: bool = False,
                    device="cuda") -> State:
    """``load_checkpoint_ex`` without the mismatch record."""
    state, _ = load_checkpoint_ex(path, cfg, force, device)
    return state
