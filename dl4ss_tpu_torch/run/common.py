"""Shared CLI plumbing: preset selection + overrides (the port of
`dl4ss_tpu/run/common.py`), plus the `--device` flag. The data-source
flags of the JAX CLIs (`--data-root`, `--split`, `--utts*`, `--metrics`)
come with the training CLIs (ROADMAP P7, P10)."""

from __future__ import annotations

import argparse

from dl4ss_tpu_torch.config import Config, preset, preset_names


def add_common_args(p: argparse.ArgumentParser) -> argparse.ArgumentParser:
    p.add_argument("--preset", default="torch_multi", choices=preset_names(),
                   help="named configuration replicating a reference config")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--seed", type=int, default=1,
                   help="reference convention: seed 1 (main_run.py:21-23)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="not ported yet (ROADMAP P7)")
    p.add_argument("--set", action="append", default=[], metavar="KEY=VALUE",
                   help="override any Config field, e.g. --set max_mix=3")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on: cuda (default; fails "
                        "without a GPU) or cpu")
    return p


def apply_overrides(cfg: Config, args) -> Config:
    """Apply the CLI's --batch-size/--set overrides onto `cfg`."""
    if args.batch_size:
        cfg = cfg.replace(batch_size=args.batch_size)
    for kv in args.set:
        key, _, value = kv.partition("=")
        current = getattr(cfg, key)  # raises on unknown key
        if isinstance(current, bool):
            parsed = value.lower() in ("1", "true", "yes")
        elif isinstance(current, int):
            parsed = int(value)
        elif isinstance(current, float):
            parsed = float(value)
        else:
            parsed = value
        cfg = cfg.replace(**{key: parsed})
    return cfg


def build_cfg(args) -> Config:
    return apply_overrides(preset(args.preset), args).validate()
