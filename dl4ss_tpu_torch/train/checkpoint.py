"""Checkpoints of the train state (the port of
`dl4ss_tpu/train/checkpoint.py`).

One file per step, `<dir>/step_<step>.pt`: the model's `state_dict`, the
Adam moments and count of the generator's parameters (and of the
discriminator's, when the model has one), the step, the state of the
generator that draws the batches, so that a resumed run draws the same
batches as an unbroken one, and the memory trainer's speaker memory (its
rows and ages) when the state has one. The payload holds only tensors,
ints, lists and dicts and loads under `torch.load(..., weights_only=True)`.
A step is written under a temporary name and moved into place with
`os.replace`, so a killed run never leaves half a step; the last 5 steps
are kept, as the JAX package's orbax manager keeps them. Beside the
steps, `cfg.json` records the training config, byte for byte as the JAX
package writes it.

The JAX package's orbax directories cannot be read here (orbax imports
jax): weights cross between the packages as parameter pytrees, through
`weights.load_jax_params` / `export_jax_params`.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
from typing import Dict, List, Optional

import torch

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.train.state import AdamState, TrainState

MAX_TO_KEEP = 5
_STEP_FILE = re.compile(r"^step_(\d+)\.pt$")


def _step_path(directory: str, step: int) -> str:
    return os.path.join(directory, f"step_{step}.pt")


def _steps(directory: str) -> List[int]:
    if not os.path.isdir(directory):
        return []
    return sorted(int(m.group(1)) for m in map(_STEP_FILE.match,
                                               os.listdir(directory)) if m)


def _write_atomic(path: str, write) -> None:
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _adam(state: Optional[AdamState]) -> Optional[dict]:
    if state is None:
        return None
    return {"count": state.count, "mu": list(state.mu), "nu": list(state.nu)}


def save_checkpoint(directory: str, state: TrainState,
                    step: Optional[int] = None,
                    cfg: Optional[Config] = None) -> int:
    """Write `state` as step `step` (default state.step) under `directory`,
    drop all but the last 5 steps, and write the `cfg.json` sidecar when
    `cfg` is given. Returns the step."""
    step = int(state.step) if step is None else int(step)
    os.makedirs(directory, exist_ok=True)
    payload = {"step": step, "model": state.model.state_dict(),
               "opt_state": _adam(state.opt_state),
               "d_opt_state": _adam(getattr(state, "d_opt_state", None)),
               "generator": state.generator.get_state()}
    memory = getattr(state, "memory", None)
    if memory is not None:
        # the memory trainer's speaker memory is model state
        payload["memory"] = {"vectors": memory.vectors, "age": memory.age}
    _write_atomic(_step_path(directory, step),
                  lambda path: torch.save(payload, path))
    for old in _steps(directory)[:-MAX_TO_KEEP]:
        os.remove(_step_path(directory, old))
    if cfg is not None:
        # the training config beside the checkpoints, so that evaluators
        # rebuild the exact state shapes (the speaker count above all)
        def write_cfg(path):
            with open(path, "w") as f:
                f.write(cfg.to_json())
        _write_atomic(os.path.join(directory, "cfg.json"), write_cfg)
    return step


def load_cfg(directory: str) -> Optional[Config]:
    """The Config the checkpoints in `directory` were trained with, if the
    trainer recorded one. Keys the current Config no longer defines are
    dropped, so that old sidecars keep loading."""
    path = os.path.join(directory, "cfg.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        raw = json.load(f)
    known = {f.name for f in dataclasses.fields(Config)}
    return Config(**{k: v for k, v in raw.items() if k in known})


def latest_step(directory: str) -> Optional[int]:
    steps = _steps(directory)
    return steps[-1] if steps else None


def _load(directory: str, step: Optional[int], device) -> dict:
    use = latest_step(directory) if step is None else step
    path = None if use is None else _step_path(directory, use)
    if path is None or not os.path.exists(path):
        what = "a checkpoint" if step is None else f"checkpoint step {step}"
        raise FileNotFoundError(f"{directory!r} holds no {what}")
    return torch.load(path, map_location=device, weights_only=True)


def _preset(directory: str) -> str:
    cfg = load_cfg(directory)
    return repr(cfg.name) if cfg is not None else "unknown (no cfg.json)"


def _check_shapes(want: Dict[str, torch.Tensor], got: Dict[str, torch.Tensor],
                  what: str, directory: str, cfg: Optional[Config]) -> None:
    """Raise ValueError, naming the donor directory and both presets, if
    the donor tensors `got` do not match `want` key for key and shape for
    shape."""
    missing = sorted(set(want) - set(got))
    extra = sorted(set(got) - set(want))
    shapes = sorted(k for k in set(want) & set(got)
                    if tuple(want[k].shape) != tuple(got[k].shape))
    if missing or extra or shapes:
        here = f" (preset {cfg.name!r})" if cfg is not None else ""
        detail = "; ".join(
            f"{label} {names[:4]}{' ...' if len(names) > 4 else ''}"
            for label, names in (("missing", missing), ("extra", extra),
                                 ("shapes differ", shapes)) if names)
        raise ValueError(
            f"{what} from {directory!r} (preset {_preset(directory)}) do not "
            f"match the model{here}: {detail}")


def _memory(payload: dict, template, directory: str):
    """The saved speaker memory, checked against the template's shapes."""
    from dl4ss_tpu_torch.models.memory import MemorySlots
    saved = payload.get("memory")
    if saved is None:
        raise ValueError(f"checkpoint in {directory!r} (preset "
                         f"{_preset(directory)}) holds no speaker memory")
    _check_shapes({"vectors": template.memory.vectors,
                   "age": template.memory.age}, saved, "the speaker memory",
                  directory, None)
    return MemorySlots(saved["vectors"], saved["age"])


def restore_checkpoint(directory: str, template: TrainState,
                       step: Optional[int] = None) -> TrainState:
    """Restore step `step` (default the latest) into `template`, a state
    built by `create_train_state` with the same config, onto the template
    model's device. The model is written in place; the optimizer states,
    the step and the batch generator's state are replaced."""
    device = next(template.model.parameters()).device
    payload = _load(directory, step, device)
    _check_shapes(template.model.state_dict(), payload["model"],
                  "the parameters", directory, None)
    template.model.load_state_dict(payload["model"])

    def adam(saved):
        if saved is None:
            return None
        return AdamState(saved["count"], list(saved["mu"]), list(saved["nu"]))

    template.opt_state = adam(payload["opt_state"])
    if hasattr(template, "d_opt_state"):
        template.d_opt_state = adam(payload["d_opt_state"])
    if hasattr(template, "memory"):
        template.memory = _memory(payload, template, directory)
    template.step = int(payload["step"])
    template.generator.set_state(payload["generator"].cpu())
    return template


def init_params_from(state: TrainState, directory: str,
                     step: Optional[int] = None,
                     cfg: Optional[Config] = None) -> TrainState:
    """Warm start: every parameter from a donor checkpoint, the optimizer
    state kept fresh (the reference's fine-tune pattern,
    TDAA_beta/main_run_sstune.py `load_state_dict` before a new
    optimizer). Raises ValueError, before anything is written, when the
    donor's parameters differ from the model's by name or shape; `cfg`
    (the model's config) names its preset in the message."""
    donor = _load(directory, step, "cpu")["model"]
    _check_shapes(state.model.state_dict(), donor, "the parameters",
                  directory, cfg)
    state.model.load_state_dict(donor)
    return state


def load_components(state: TrainState, sources: Dict[str, str],
                    step: Optional[int] = None,
                    cfg: Optional[Config] = None) -> TrainState:
    """Checkpoint-zoo composition: graft model components (`encoder`,
    `classifier`, ...) from possibly different checkpoints into `state`,
    leaving everything else untouched (the reference's hand-assembled eval
    zoo, TDAA_beta/main_run_sstune_TestVer.py:557-579):

        state = load_components(state, {"classifier": "ck_cls"})

    Every component is read and checked before any is written: KeyError
    for a component the model or the donor lacks, ValueError (naming the
    donor and both presets) for mismatched shapes."""
    grafts = []
    for component, directory in sources.items():
        target = getattr(state.model, component, None)
        donor = _load(directory, step, "cpu")["model"]
        prefix = component + "."
        sub = {k[len(prefix):]: v for k, v in donor.items()
               if k.startswith(prefix)}
        if target is None or not sub:
            have = sorted({k.split(".")[0] for k in donor})
            raise KeyError(
                f"checkpoint {directory!r} has no component {component!r} "
                f"for this model; available: {have}")
        _check_shapes(target.state_dict(), sub,
                      f"component {component!r}", directory, cfg)
        grafts.append((target, sub))
    for target, sub in grafts:
        target.load_state_dict(sub)
    return state
