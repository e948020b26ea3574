"""The port's public surface against the JAX package's.

Walks `dl4ss_tpu/` with `ast` (nothing of it is imported, so JAX is not
either) and collects every public module-level function and class, with
its parameter names (a class: its `__init__`'s, or its fields), and every
name that a package `__init__.py` imports. For each the port must have
the same name at the same path, import it, and take every JAX parameter
name; or MAP below names the port's counterpart and says why it differs.
A name the port lacks with no MAP entry fails, listed with all the others;
so does a MAP entry that has gone stale (its JAX name or parameter is gone,
its counterpart is missing, or the port now has the JAX name itself).
"""

from __future__ import annotations

import ast
import importlib
import inspect
import os
from typing import Dict, List, Optional, Tuple

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_PKG, PORT_PKG = "dl4ss_tpu", "dl4ss_tpu_torch"

_KERNELS = ("the port's kernel wrappers keep their own names: a CUDA "
            "kernel replaces each Pallas body")

# Where the port departs from a JAX name, module or parameter, and why.
#   "module"             -> ("port module", why): a JAX module the port
#                           keeps under another name; its names are looked
#                           up there under their own names
#   "module.name"        -> ("port module.name", why)
#   "module.name(param)" -> ("port param", why)
#   "*(param)"           -> ("port param|other", why): every JAX function
#                           that takes `param` takes one of these instead
MAP: Dict[str, Tuple[str, str]] = {
    "ops.pallas_stft": ("ops.stft_kernels",
                        "the Pallas DSP kernels' wrappers: CUDA K1, K4, "
                        "K9, K10"),
    "ops.pallas_rnn": ("ops.rnn_kernels",
                       "the Pallas recurrent kernels' wrappers: CUDA K2, "
                       "K5, K7, K8"),
    "ops.pallas_maskhead": ("ops.maskhead_kernels",
                            "the Pallas mask-head kernels' wrappers: CUDA "
                            "K3, K6"),
    "ops.pallas_stft.pallas_stft": ("ops.stft_kernels.stft_kernel", _KERNELS),
    "ops.pallas_stft.pallas_stft_ri": ("ops.stft_kernels.stft_ri", _KERNELS),
    "ops.pallas_stft.pallas_istft": ("ops.stft_kernels.istft_kernel",
                                     _KERNELS),
    "ops.pallas_stft.pallas_istft_ri": ("ops.stft_kernels.istft_ri",
                                        _KERNELS),
    "ops.pallas_stft.pallas_spectral_feature": (
        "ops.stft_kernels.spectral_feature_kernel", _KERNELS),
    "ops.pallas_stft.pallas_stft_features": ("ops.stft_kernels.stft_features",
                                             _KERNELS),
    "ops.pallas_stft.pallas_masked_istft": ("ops.stft_kernels.masked_istft",
                                            _KERNELS),
    "ops.pallas_rnn.pallas_gru_scan": ("ops.rnn_kernels.gru_scan", _KERNELS),
    "ops.pallas_rnn.pallas_lstm_scan": ("ops.rnn_kernels.lstm_scan",
                                        _KERNELS),
    "*(key)": ("generator|seed",
               "JAX PRNG keys become torch.Generators, or an int seed where "
               "the state makes its own generator"),
    "*(params)": ("model", "JAX parameter pytrees become nn.Module trees"),
    "*(rng)": ("generator", "a state's JAX PRNG key becomes its "
               "torch.Generator"),
    "data.listsampler.draw_same_speaker_rows(key)": (
        "r", "the caller draws the uniform numbers from its generator and "
        "passes them, as the list sampler needs them per row"),
    "data.listsampler.mix_from_list(shift_key)": (
        "shifts", "the circular shifts are drawn by the caller's "
        "torch.Generator and passed in"),
    "data.loader.device_prefetch(sharding)": (
        "device", "a torch device in place of a jax.sharding.Sharding"),
    "parallel.mesh.replicated(mesh)": (
        "tensors", "a broadcast of the tensors from rank 0 in place of a "
        "replicated NamedSharding over the mesh"),
    "ops.stft.masked_resynthesis(spec)": (
        "re", "the spectrum comes as its (re, im) halves: the port's STFT "
        "kernel emits them, and no complex tensor is formed"),
}


def _params(node) -> List[str]:
    """The parameter names of a FunctionDef, or of a ClassDef (its
    `__init__`'s but self, else its annotated fields)."""
    if isinstance(node, ast.ClassDef):
        for item in node.body:
            if isinstance(item, ast.FunctionDef) and item.name == "__init__":
                return _params(item)[1:]
        return [item.target.id for item in node.body
                if isinstance(item, ast.AnnAssign)
                and isinstance(item.target, ast.Name)]
    a = node.args
    return [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]


def jax_surface():
    """(definitions, exports): {(module, name): params} for every public
    module-level function and class of the JAX package, and
    {(package, name): (source module, source name)} for every name a
    package `__init__.py` imports. Modules are dotted paths below the
    package ("" is the package itself)."""
    defs: Dict[Tuple[str, str], List[str]] = {}
    exports: Dict[Tuple[str, str], Tuple[str, str]] = {}
    base = os.path.join(ROOT, JAX_PKG)
    for root, _, files in os.walk(base):
        for f in sorted(files):
            if not f.endswith(".py"):
                continue
            rel = os.path.relpath(os.path.join(root, f), base)[:-3]
            parts = rel.split(os.sep)
            if parts[-1] == "__init__":
                parts = parts[:-1]
            mod = ".".join(parts)
            with open(os.path.join(root, f)) as fh:
                tree = ast.parse(fh.read())
            for node in tree.body:
                if (isinstance(node, (ast.FunctionDef, ast.ClassDef))
                        and not node.name.startswith("_")):
                    defs[mod, node.name] = _params(node)
                if (f == "__init__.py" and isinstance(node, ast.ImportFrom)
                        and node.module.startswith(JAX_PKG + ".")):
                    src = node.module[len(JAX_PKG) + 1:]
                    for alias in node.names:
                        if not alias.name.startswith("_"):
                            exports[mod, alias.asname or alias.name] = (
                                src, alias.name)
    return defs, exports


def _port(path: str):
    """The port's object at "module" or "module.name" (None if missing)."""
    try:
        return importlib.import_module(f"{PORT_PKG}.{path}".rstrip("."))
    except ModuleNotFoundError:
        pass
    mod, _, name = path.rpartition(".")
    try:
        module = importlib.import_module(f"{PORT_PKG}.{mod}".rstrip("."))
    except ModuleNotFoundError:
        return None
    return getattr(module, name, None)


def counterpart(mod: str, name: str) -> Tuple[str, str]:
    """The port's (module, name) for the JAX definition (mod, name)."""
    full = f"{mod}.{name}"
    if full in MAP:
        port_mod, _, port_name = MAP[full][0].rpartition(".")
        return port_mod, port_name
    if mod in MAP:
        return MAP[mod][0], name
    return mod, name


def _port_params(obj) -> Optional[List[str]]:
    try:
        return list(inspect.signature(obj).parameters)
    except (TypeError, ValueError):
        return None


def _param_entry(mod, name, param, port_params) -> Optional[str]:
    """The MAP key that supplies a JAX parameter the port does not take
    under its own name, or None."""
    for key in (f"{mod}.{name}({param})", f"*({param})"):
        if key in MAP and any(p in port_params
                              for p in MAP[key][0].split("|")):
            return key
    return None


def surface_problems():
    """(unmapped, stale): the JAX names and parameters the port lacks with
    no MAP entry, and the MAP entries that no longer apply."""
    defs, exports = jax_surface()
    unmapped, used = [], set()
    for (mod, name), params in sorted(defs.items()):
        pmod, pname = counterpart(mod, name)
        if f"{mod}.{name}" in MAP:
            used.add(f"{mod}.{name}")
        if (mod, name) != (pmod, pname) and mod in MAP:
            used.add(mod)
        obj = _port(f"{pmod}.{pname}")
        if obj is None:
            unmapped.append(f"{mod}.{name}: no {PORT_PKG}.{pmod}.{pname}")
            continue
        if (mod, name) != (pmod, pname):
            continue            # a kernel wrapper: its own contract
        port_params = _port_params(obj)
        if port_params is None:
            unmapped.append(f"{mod}.{name}: no signature in the port")
            continue
        for param in params:
            if param in port_params:
                continue
            key = _param_entry(mod, name, param, port_params)
            if key is None:
                unmapped.append(f"{mod}.{name}({param}): the port takes "
                                f"{port_params}")
            else:
                used.add(key)
    for (pkg, name), (src, src_name) in sorted(exports.items()):
        pmod, pname = counterpart(src, src_name)
        want = _port(f"{pmod}.{pname}")
        got = getattr(_port(pkg), pname if name == src_name else name, None)
        label = f"from {JAX_PKG}.{pkg} import {name}".replace("..", ".")
        if got is None or got is not want:
            unmapped.append(f"{label}: {PORT_PKG}.{pkg} does not export "
                            f"{pmod}.{pname} as {pname}")
    stale = []
    for key, (target, reason) in MAP.items():
        if not reason.strip():
            stale.append(f"{key}: no reason given")
        if key.startswith("*("):
            if key not in used:
                stale.append(f"{key}: no JAX function takes it")
            continue
        if "(" in key:
            fn, param = key[:-1].split("(")
            mod, _, name = fn.rpartition(".")
            obj = _port(fn)
            if param not in defs.get((mod, name), []):
                stale.append(f"{key}: JAX's {fn} takes no {param}")
            elif obj is None or target not in (_port_params(obj) or []):
                stale.append(f"{key}: the port's {fn} takes no {target}")
            elif key not in used:
                stale.append(f"{key}: the port takes {param} itself")
            continue
        if key not in used:
            stale.append(f"{key}: no JAX definition there")
        elif _port(target) is None:
            stale.append(f"{key}: no {PORT_PKG}.{target}")
        elif _port(key) is not None:
            stale.append(f"{key}: the port has {key} itself")
    return unmapped, stale


def test_every_jax_name_has_its_counterpart_in_the_port():
    unmapped, _ = surface_problems()
    assert not unmapped, "\n".join(["unmapped:"] + unmapped)


def test_no_map_entry_is_stale():
    _, stale = surface_problems()
    assert not stale, "\n".join(["stale:"] + stale)


def test_the_walk_sees_the_whole_jax_surface():
    """The walk itself: it finds the names it must (a definition in a
    package `__init__`, a Pallas module's, a function's parameters, the
    exports of every subpackage), so an empty walk cannot pass."""
    defs, exports = jax_surface()
    assert ("native", "resample_poly") in defs
    assert ("ops.pallas_stft", "pallas_spectral_feature") in defs
    assert defs["ops.rnn", "rnn_init"][-2:] == ["bidirectional", "dtype"]
    assert exports["ops", "stft"] == ("ops.stft", "stft")
    assert {pkg for pkg, _ in exports} >= {
        "", "data", "eval", "models", "objectives", "ops", "parallel", "run",
        "train", "utils"}
    assert len(defs) > 200 and len(exports) > 100
