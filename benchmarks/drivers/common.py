"""What the drivers share: the port's ``Config`` built from the
configuration's file (with what the traffic mix plans differently), the
checkpoint's arrays, the name of each of the port's parameters in the
checkpoint, the recorder of a timed step's arguments and results, and the
sample of a run's outputs that the reference judges."""

from __future__ import annotations

import copy
from pathlib import Path

import numpy as np
import torch

from benchmarks.harness import ROOT

SEED_MASK = 2 ** 32 - 1  # scenario keys take a 32-bit seed


def port_config(cfg: dict):
    """The port's ``Config`` holding the file's ``env``, ``policy`` and
    ``train`` groups (lists as tuples)."""
    from relationalgraphlearning_tpu_torch.configs import base

    def build(cls, group: dict):
        kw = {}
        for f in cls.__dataclass_fields__.values():
            if f.name not in group:
                continue
            v = group[f.name]
            sub = getattr(base, f.type, None) if isinstance(f.type, str) \
                else f.type
            if isinstance(v, dict) and sub is not None:
                v = build(sub, v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[f.name] = v
        return cls(**kw)

    return base.Config(env=build(base.EnvConfig, cfg["env"]),
                       policy=build(base.PolicyConfig, cfg["policy"]),
                       train=build(base.TrainConfig, cfg["train"]))


def planned(cfg: dict, traffic: dict) -> dict:
    """The configuration as the mix plans it: a copy with the traffic's
    ``planning_width`` where the mix gives one (the same weights planned
    wider), else the configuration itself."""
    if "planning_width" not in traffic:
        return cfg
    cfg = copy.deepcopy(cfg)
    cfg["policy"]["mprl"]["planning_width"] = traffic["planning_width"]
    return cfg


def checkpoint_arrays(cfg: dict) -> dict:
    """{flax path: numpy array} of the configuration's weights file."""
    with np.load(Path(ROOT) / cfg["weights"]) as z:
        return {k: z[k] for k in z.files}


def to_device(arrays: dict, device) -> dict:
    """The reference's weights: flax paths without ``params/``."""
    return {k.split("/", 1)[1]: torch.as_tensor(v, device=device)
            for k, v in arrays.items()}


def flax_name(torch_name: str) -> tuple[str, bool]:
    """The checkpoint's path of one of the port's parameters, and whether
    its layout is transposed (a Linear's weight is the kernel's
    transpose)."""
    parts = torch_name.split(".")
    out = []
    i = 0
    while i < len(parts):
        p = parts[i]
        if p in ("layers", "gcn_layers") and i + 1 < len(parts):
            k = int(parts[i + 1])
            out.append(f"dense_{k}" if p == "layers" else f"gcn_w{k + 1}")
            i += 2
            continue
        out.append({"weight": "kernel"}.get(p, p))
        i += 1
    return "/".join(out), parts[-1] == "weight"


def as_reference(names, tensors) -> dict:
    """The port's parameters (or any tensors laid out as them) keyed and
    laid out as the reference's weights."""
    out = {}
    for n, t in zip(names, tensors):
        key, transposed = flax_name(n)
        out[key] = t.detach().t().contiguous() if transposed \
            else t.detach().clone()
    return out


def sample(rng: np.random.Generator, population: int, k: int) -> np.ndarray:
    """``k`` distinct draws of [0, population) (all when fewer)."""
    return np.sort(rng.choice(population, size=min(k, population),
                              replace=False))


def check_rng(seed: int) -> np.random.Generator:
    """The generator that draws the judged sample, apart from the program's
    draws."""
    return np.random.default_rng([seed & SEED_MASK, seed >> 32, 7])


class Recorder:
    """A step of the program as its caller calls it, keeping the arguments
    and results of the calls that ``keep(n)`` picks (``n`` counts the
    calls) as ``(n, inputs, outputs)``: the program's own step, unchanged,
    and nothing cloned on the other calls."""

    def __init__(self, step, keep):
        self.step, self.keep = step, keep
        self.seen = 0
        self.kept: list = []

    def __call__(self, *args, **kwargs):
        keep = self.keep(self.seen)
        if keep:
            inputs = tuple(a.clone() for a in args)
        out = self.step(*args, **kwargs)
        if keep:
            self.kept.append((self.seen, inputs,
                              tuple(o.clone() for o in out)))
        self.seen += 1
        return out
