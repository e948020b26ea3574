"""Port recurrences (dl4ss_tpu_torch.ops.rnn / rnn_kernels) against the
JAX reference on the CPU, with the same weights (a JAX `rnn_init` tree
converted to numpy) and the same numpy inputs. Forward tolerance 1e-5:
both sides compute in f32 and differ only in summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu.ops.pallas_rnn import pallas_gru_scan
from dl4ss_tpu.ops.rnn import bidirectional_rnn as jax_birnn
from dl4ss_tpu.ops.rnn import rnn_init as jax_rnn_init
from dl4ss_tpu_torch.ops import rnn_kernels
from dl4ss_tpu_torch.ops.rnn import bidirectional_rnn, rnn_init
from dl4ss_tpu_torch.weights import load_jax_params

ATOL = 1e-5


def _stack(cell, d, h, layers, seed):
    jl = jax_rnn_init(jax.random.PRNGKey(seed), cell, d, h, layers)
    tl = rnn_init(cell, d, h, layers, device="cpu")
    load_jax_params(tl, jax.tree_util.tree_map(np.asarray, jl))
    return jl, tl


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("port_kernel_route", [False, True])
def test_birnn_matches_jax(cell, jax_pallas, port_kernel_route):
    """The port's plain loop and its kernel route (K2's plain version on
    CPU tensors; LSTM takes the loop) against JAX's scan and Pallas
    (interpret mode) routes."""
    jl, tl = _stack(cell, 9, 6, 2, seed=0)
    x = np.random.default_rng(0).standard_normal((3, 11, 9)).astype(
        np.float32)
    ref = jax_birnn(jl, jnp.asarray(x), cell, use_pallas=jax_pallas)
    ours = bidirectional_rnn(tl, torch.as_tensor(x), cell,
                             use_pallas=port_kernel_route)
    assert tuple(ours.shape) == ref.shape == (3, 11, 12)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL)


def test_gru_scan_plain_matches_pallas_gru_scan():
    """K2's plain version against the Pallas kernel body itself (interpret
    mode) on the same fused inputs. The Pallas kernel needs Hp % 128 == 0,
    so H=128 here; the port has no such constraint."""
    rng = np.random.default_rng(1)
    t, b, h = 5, 2, 128
    xp = rng.standard_normal((t, 2, b, 3 * h)).astype(np.float32)
    wh = rng.uniform(-0.1, 0.1, (2, h, 3 * h)).astype(np.float32)
    bhn = rng.uniform(-0.1, 0.1, (2, 1, h)).astype(np.float32)
    ref = pallas_gru_scan(jnp.asarray(xp), jnp.asarray(wh), jnp.asarray(bhn))
    ours = rnn_kernels.gru_scan(torch.as_tensor(xp), torch.as_tensor(wh),
                                torch.as_tensor(bhn))
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL)


def test_gru_matches_torch_nn_gru():
    """The JAX layout with torch gate order equals torch.nn.GRU (weights
    transposed into nn.GRU's (G*H, D) layout)."""
    _, tl = _stack("gru", 5, 4, 1, seed=2)
    ref_rnn = torch.nn.GRU(5, 4, batch_first=True, bidirectional=True)
    c = tl[0]
    with torch.no_grad():
        for suffix, cellp in (("", c.fwd), ("_reverse", c.bwd)):
            getattr(ref_rnn, "weight_ih_l0" + suffix).copy_(cellp.wx.T)
            getattr(ref_rnn, "weight_hh_l0" + suffix).copy_(cellp.wh.T)
            getattr(ref_rnn, "bias_ih_l0" + suffix).copy_(cellp.bx)
            getattr(ref_rnn, "bias_hh_l0" + suffix).copy_(cellp.bh)
    x = torch.as_tensor(np.random.default_rng(3).standard_normal(
        (2, 7, 5)).astype(np.float32))
    with torch.no_grad():
        ref, _ = ref_rnn(x)
        for route in (False, True):
            torch.testing.assert_close(
                bidirectional_rnn(tl, x, "gru", use_pallas=route), ref,
                atol=ATOL, rtol=0)


def test_bf16_kernel_route_keeps_dtype():
    _, tl = _stack("gru", 6, 5, 1, seed=4)
    x = torch.randn((2, 4, 6), generator=torch.Generator().manual_seed(0))
    out = bidirectional_rnn(tl, x.bfloat16(), "gru", use_pallas=True)
    ref = bidirectional_rnn(tl, x, "gru", use_pallas=True)
    assert out.dtype == torch.bfloat16
    # bf16 operands and carry with f32 accumulation
    torch.testing.assert_close(out.float(), ref, atol=3e-2, rtol=0)
