"""Unified run configuration (a copy of ``diffnet_tpu/config.py``; pure
Python).

The reference mixes six configuration mechanisms (argparse per script,
**kwargs soak-up, module constants, AttrDict, libconf .inp files, and shell
scripts that sed-edit source — SURVEY.md §5). This replaces all of them with
one dataclass + CLI/file round-trip.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
from typing import Any

__all__ = ["RunConfig", "add_config_args", "config_from_args",
           "config_from_inp"]


@dataclasses.dataclass
class RunConfig:
    # problem
    domain_size: int = 64
    domain_length: float = 1.0
    nsd: int = 2
    fem_basis_deg: int = 1
    loss_type: str = "resmin"          # energy | resmin | strong | ...
    # training
    batch_size: int = 1
    max_epochs: int = 100
    optimizer: str = "lbfgs"           # adam | sgd | lbfgs
    learning_rate: float = 3e-4
    lbfgs_max_iter: int = 10
    lr_milestones: tuple[int, ...] = ()
    lr_gamma: float = 0.1
    seed: int = 42
    fast_dev_run: bool = False
    # io
    out_dir: str = "runs"
    run_name: str = "run"
    checkpoint: bool = True
    plot_frequency: int = 50
    # parallel
    mesh_data: int = 1
    mesh_space: int = 1

    def to_json(self, path: str):
        with open(path, "w") as f:
            json.dump(dataclasses.asdict(self), f, indent=2)

    @classmethod
    def from_json(cls, path: str) -> "RunConfig":
        with open(path) as f:
            raw = json.load(f)
        known = {f.name for f in dataclasses.fields(cls)}
        # JSON has no tuples: restore the tuple invariant for list values
        # (a list default would make add_config_args register type=list,
        # turning '--lr-milestones 100' into ('1','0','0'))
        return cls(**{k: (tuple(v) if isinstance(v, list) else v)
                      for k, v in raw.items() if k in known})

    def replace(self, **kw) -> "RunConfig":
        return dataclasses.replace(self, **kw)


def add_config_args(parser: argparse.ArgumentParser,
                    defaults: RunConfig | None = None):
    """Register every RunConfig field as a --kebab-case CLI flag."""
    defaults = defaults or RunConfig()
    for f in dataclasses.fields(RunConfig):
        name = "--" + f.name.replace("_", "-")
        default = getattr(defaults, f.name)
        if f.type == "bool" or isinstance(default, bool):
            # --flag / --no-flag so default-True booleans are controllable
            parser.add_argument(name, action=argparse.BooleanOptionalAction,
                                default=default)
        elif isinstance(default, tuple):
            parser.add_argument(name, type=int, nargs="*",
                                default=list(default))
        else:
            parser.add_argument(name, type=type(default), default=default)
    return parser


def config_from_args(args: argparse.Namespace) -> RunConfig:
    known = {f.name for f in dataclasses.fields(RunConfig)}
    kw: dict[str, Any] = {}
    for k, v in vars(args).items():
        if k in known:
            kw[k] = tuple(v) if isinstance(v, list) else v
    return RunConfig(**kw)


def _parse_inp(text: str) -> dict:
    """Minimal libconf-style `.inp` parser for flat `key = value;` configs
    (the reference's conf_e8_2d.inp / conf_e8_poisson3d.inp format, loaded
    with the libconf package which this image doesn't ship)."""
    out: dict[str, Any] = {}

    def strip_comment(s: str) -> str:
        # drop #/// comments, but not inside a quoted value
        quoted = False
        for i, ch in enumerate(s):
            if ch == '"':
                quoted = not quoted
            elif not quoted and (ch == "#" or s[i:i + 2] == "//"):
                return s[:i]
        return s

    for raw in text.splitlines():
        line = strip_comment(raw).strip().rstrip(";")
        if not line or "=" not in line:
            continue
        key, val = (p.strip() for p in line.split("=", 1))
        if val.startswith('"') and val.endswith('"'):
            out[key] = val[1:-1]
        elif val.lower() in ("true", "false"):
            out[key] = val.lower() == "true"
        else:
            try:
                out[key] = int(val)
            except ValueError:
                try:
                    out[key] = float(val)
                except ValueError:
                    out[key] = val
    return out


def config_from_inp(path: str, base: RunConfig | None = None,
                    return_extras: bool = False):
    """Load a reference-style .inp file into a RunConfig. Unknown keys are
    NOT silently dropped: pass ``return_extras=True`` to receive them as a
    second dict (problem parameters like the reference's ``nu``/``Nx``)."""
    with open(path) as f:
        raw = _parse_inp(f.read())
    cfg = base or RunConfig()
    known = {f.name for f in dataclasses.fields(RunConfig)}
    alias = {"LR": "learning_rate"}  # reference key spellings
    kw, extras = {}, {}
    for k, v in raw.items():
        k2 = alias.get(k, k)
        (kw if k2 in known else extras).__setitem__(k2, v)
    cfg = cfg.replace(**kw)
    return (cfg, extras) if return_extras else cfg
