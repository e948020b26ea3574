"""The PyTorch port's config copy, package boundary and device rule."""

import ast
import dataclasses
import pathlib

import pytest
import torch

import dl4ss_tpu.config as jcfg
import dl4ss_tpu_torch.config as tcfg
from dl4ss_tpu_torch import resolve_device

ROOT = pathlib.Path(__file__).resolve().parent.parent


def test_preset_names_match():
    assert tcfg.preset_names() == jcfg.preset_names()


@pytest.mark.parametrize("name", jcfg.preset_names())
def test_preset_equals_jax_field_for_field(name):
    ours, ref = tcfg.preset(name), jcfg.preset(name)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)
    assert (ours.max_len, ours.freq_bins, ours.num_frames, ours.query_dim) \
        == (ref.max_len, ref.freq_bins, ref.num_frames, ref.query_dim)
    assert ours.to_json() == ref.to_json()


def test_config_fields_and_defaults_match():
    ours = {f.name: f.default for f in dataclasses.fields(tcfg.Config)}
    ref = {f.name: f.default for f in dataclasses.fields(jcfg.Config)}
    assert ours == ref


def _imported_roots(path):
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.module:
            if node.level == 0:
                yield node.module.split(".")[0]


def test_port_imports_no_jax_and_nothing_of_the_jax_package():
    """An AST scan, not sys.modules: jax is imported at interpreter start
    in some images, so only the source can show what the port imports."""
    files = sorted((ROOT / "dl4ss_tpu_torch").rglob("*.py"))
    files.append(ROOT / "chip_smoke.py")
    assert len(files) > 20
    banned = {"jax", "jaxlib", "flax", "optax", "orbax", "dl4ss_tpu"}
    bad = {str(f.relative_to(ROOT)): sorted(set(_imported_roots(f)) & banned)
           for f in files}
    assert {f: b for f, b in bad.items() if b} == {}


def test_resolve_device_cpu_and_default():
    assert resolve_device("cpu") == torch.device("cpu")
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device()
        with pytest.raises(RuntimeError, match="no CUDA device"):
            resolve_device("cuda")
    with pytest.raises(ValueError):
        resolve_device("meta")
