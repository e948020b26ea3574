"""The harness's side of the program under test: its configuration, its
model loaded with the benchmark's weights, and the run's context. The
harness imports the program (`dl4ss_tpu_torch`) inside functions only.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import NamedTuple

from benchmark.reference.params import make_params


class Ctx(NamedTuple):
    cell: str
    seed: int
    seconds: float          # the measured window's length
    device: object          # torch.device
    config: dict            # the configuration file
    traffic: dict           # the traffic file
    limits: dict            # the cell's limits, by check name

    def sub_seed(self, tag: str) -> int:
        """A seed of its own for each use, from the run's seed."""
        h = hashlib.sha256(f"{self.seed}:{tag}".encode()).digest()
        return int.from_bytes(h[:8], "little") >> 1

    @property
    def ref(self) -> dict:
        """The configuration as the reference reads it."""
        return reference_config(self.config)


def reference_config(config_file: dict) -> dict:
    return dict(config_file["config"], **config_file["derived"],
                precision=config_file["precision"])


def port_config(config_file: dict):
    """The program's Config: its preset with every field the file states,
    checked against the file's derived sizes."""
    from dl4ss_tpu_torch.config import Config, preset
    fields = {f.name for f in dataclasses.fields(Config)}
    unknown = set(config_file["config"]) - fields
    if unknown:
        raise ValueError(f"configuration keys the program lacks: {unknown}")
    cfg = preset(config_file["preset"]).replace(**config_file["config"])
    derived = config_file["derived"]
    got = {"max_len": cfg.max_len, "freq_bins": cfg.freq_bins,
           "num_frames": cfg.num_frames}
    if any(got[k] != derived[k] for k in got):
        raise ValueError(f"derived sizes {got} differ from {derived}")
    return cfg


def build_model(ctx: Ctx, cfg):
    """The program's separator on the run's device, holding the weights
    of the run's seed (made on the device, loaded by name)."""
    from dl4ss_tpu_torch.models.separator import init_separator
    weights = make_params(ctx.ref, ctx.sub_seed("weights"), ctx.device)
    model = init_separator(cfg, device=ctx.device)
    model.load_state_dict(weights, strict=True)
    return model
