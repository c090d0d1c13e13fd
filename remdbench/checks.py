"""What decides ``correct``: the program's outputs judged by the plain
reference (``reference/``), and the control that has to fail.

The reference is put together from the configuration's own fields, each
naming a module of ``reference/``:

  system.kind              ``system_<kind>``: the system from the
                           configuration's numbers, as host arrays
  reference.model          ``model_<model>``: forces, energies, the
                           integrator and its noise, the start
  exchange.exchange_scheme ``exchange_<scheme>``: the exchange's
                           decisions and the check of every history row
  exchange.pattern         ``pattern_<pattern>``: the keys of a cycle,
                           the numbers a run is judged by (``judge``) and
                           the control in the program's place
                           (``control_run``)

so that a configuration of another kind, scheme or pattern brings its own
module and changes none of these.  ``control_readings`` puts the
reference computed in bfloat16 (all of it, or only the exchange's
features) in the program's place and judges it as a run of the program
is judged.
"""
from __future__ import annotations

import importlib
from dataclasses import dataclass
from types import ModuleType
from typing import Any, Dict

import numpy as np
import torch


@dataclass
class Reference:
    system: Any
    model: Any
    exchange: ModuleType
    pattern: ModuleType


def _module(kind: str, name: str) -> ModuleType:
    return importlib.import_module(f"remdbench.reference.{kind}_{name}")


def system(config: Dict):
    """The configuration's system (host arrays) and its module."""
    mod = _module("system", config["system"]["kind"])
    return mod.build(config["system"]), mod


def reference(config: Dict, device, dtype=torch.float32,
              feature_dtype=None, built=None) -> Reference:
    """The reference of a resolved configuration (the cell's traffic
    merged in); ``built``: its system, when already built."""
    sysm = built if built is not None else system(config)[0]
    model = _module("model", config["reference"]["model"]).Model(
        sysm, config, torch.device(device), dtype, feature_dtype)
    return Reference(sysm, model,
                     _module("exchange", config["exchange"]["exchange_scheme"]),
                     _module("pattern", config["exchange"]["pattern"]))


def judge(ref: Reference, seed: int, run: Dict) -> Dict[str, float]:
    return ref.pattern.judge(ref, seed, run)


CONTROL_PARTS = ("all", "features")


def control_readings(config: Dict, seed: int, chunk_cycles: int, device,
                     part: str = "all") -> Dict[str, float]:
    """The control judged by the float32 reference at the configuration's
    sizes: ``part`` "all", the reference in bfloat16 throughout; or
    "features", only the exchange's feature pass in bfloat16."""
    sysm = system(config)[0]
    ref = reference(config, device, built=sysm)
    ctl = (reference(config, device, torch.bfloat16, built=sysm)
           if part == "all" else
           reference(config, device, torch.float32, torch.bfloat16,
                     built=sysm))
    md_steps = int(config["exchange"]["md_steps_per_cycle"])
    run = ctl.pattern.control_run(ctl, seed, md_steps, chunk_cycles)
    return judge(ref, seed, run)


def verdict(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every compared number at or under its limit (NaN fails)."""
    return all(np.isfinite(numbers[k]) and numbers[k] <= limits[k]
               for k in limits)
