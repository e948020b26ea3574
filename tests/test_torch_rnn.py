"""Port recurrences (dl4ss_tpu_torch.ops.rnn / rnn_kernels) against the
JAX reference on the CPU, with the same weights (a JAX `rnn_init` tree
converted to numpy) and the same numpy inputs. Forward tolerance 1e-5:
both sides compute in f32 and differ only in summation order."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dl4ss_tpu.ops.pallas_rnn import (_lstm_fwd, pallas_gru_scan,
                                      pallas_lstm_scan)
from dl4ss_tpu.ops.rnn import bidirectional_rnn as jax_birnn
from dl4ss_tpu.ops.rnn import gru_init as jax_gru_init
from dl4ss_tpu.ops.rnn import lstm_init as jax_lstm_init
from dl4ss_tpu.ops.rnn import rnn_init as jax_rnn_init
from dl4ss_tpu_torch.ops import rnn_kernels
from dl4ss_tpu_torch.ops.rnn import (bidirectional_rnn, gru_init, lstm_init,
                                     rnn_init)
from dl4ss_tpu_torch.weights import (export_jax_params, flatten_tree,
                                     load_jax_params)

ATOL = 1e-5


def _stack(cell, d, h, layers, seed, bidirectional=True):
    jl = jax_rnn_init(jax.random.PRNGKey(seed), cell, d, h, layers,
                      bidirectional=bidirectional)
    tl = rnn_init(cell, d, h, layers, device="cpu",
                  bidirectional=bidirectional)
    load_jax_params(tl, jax.tree_util.tree_map(np.asarray, jl))
    return jl, tl


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("jax_pallas", [False, True])
@pytest.mark.parametrize("port_kernel_route", [False, True])
def test_birnn_matches_jax(cell, jax_pallas, port_kernel_route):
    """The port's plain loop and its kernel route (K2's and K7's plain
    versions on CPU tensors) against JAX's scan and Pallas (interpret mode)
    routes."""
    jl, tl = _stack(cell, 9, 6, 2, seed=0)
    x = np.random.default_rng(0).standard_normal((3, 11, 9)).astype(
        np.float32)
    ref = jax_birnn(jl, jnp.asarray(x), cell, use_pallas=jax_pallas)
    ours = bidirectional_rnn(tl, torch.as_tensor(x), cell,
                             use_pallas=port_kernel_route)
    assert tuple(ours.shape) == ref.shape == (3, 11, 12)
    np.testing.assert_allclose(ours.detach().numpy(), np.asarray(ref), atol=ATOL)


@functools.lru_cache(maxsize=None)
def _one_direction_jax(cell):
    """JAX's 2-layer one-direction stack (`rnn_init(bidirectional=False)`:
    each layer holds `fwd` alone, run as a `lax.scan`), an input, a
    cotangent, and JAX's output and gradients (numpy)."""
    jl = jax_rnn_init(jax.random.PRNGKey(21), cell, 9, 6, 2,
                      bidirectional=False)
    rng = np.random.default_rng(22)
    x = rng.standard_normal((3, 11, 9)).astype(np.float32)
    cot = rng.standard_normal((3, 11, 6)).astype(np.float32)

    def loss(params, xx):
        return jnp.sum(jax_birnn(params, xx, cell) * jnp.asarray(cot))

    out = jax_birnn(jl, jnp.asarray(x), cell)
    ref_p, ref_x = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(x))
    tree = dict(flatten_tree(jax.tree_util.tree_map(np.asarray, jl)))
    grads = dict(flatten_tree(jax.tree_util.tree_map(np.asarray, ref_p)))
    return jl, x, cot, np.asarray(out), np.asarray(ref_x), tree, grads


@pytest.mark.parametrize("cell", ["gru", "lstm"])
@pytest.mark.parametrize("port_kernel_route", [False, True])
def test_one_direction_stack_matches_jax(cell, port_kernel_route):
    """A one-direction stack on the port's plain loop and on its kernel
    route (gru_scan / lstm_scan with D = 1: K2 / K7 and K5 / K8's plain
    versions here) against JAX's: (B, T, H) out within 1e-5, the gradients
    of the input and of every parameter within 1e-4 (f32 both sides:
    summation order only). The weights go both ways: the port's export is
    the JAX tree, leaf for leaf."""
    jl, x, cot, ref, ref_x, tree, ref_grads = _one_direction_jax(cell)
    tl = rnn_init(cell, 9, 6, 2, device="cpu", bidirectional=False)
    load_jax_params(tl, jax.tree_util.tree_map(np.asarray, jl))
    exported = dict(flatten_tree(export_jax_params(tl)))
    assert set(exported) == set(tree)
    assert all(k.split(".")[1] == "fwd" for k in exported)
    for name, want in tree.items():
        np.testing.assert_array_equal(exported[name], want, err_msg=name)
    xt = torch.as_tensor(x).requires_grad_()
    out = bidirectional_rnn(tl, xt, cell, use_pallas=port_kernel_route)
    assert tuple(out.shape) == ref.shape == (3, 11, 6)
    np.testing.assert_allclose(out.detach().numpy(), ref, atol=ATOL)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), ref_x, atol=1e-4)
    grads = {n: p.grad for n, p in tl.named_parameters()}
    assert set(grads) == set(ref_grads)
    for name, want in ref_grads.items():
        np.testing.assert_allclose(grads[name].numpy(), want, atol=1e-4,
                                   rtol=1e-4, err_msg=name)


@pytest.mark.parametrize("cell", ["gru", "lstm"])
def test_one_direction_remat_is_bit_equal(cell):
    """`remat` on a one-direction stack (each layer recomputed in the
    backward from its input alone, on the kernel route) gives the same
    output and gradients bit for bit as the stack without it."""
    tl = rnn_init(cell, 5, 4, 2, torch.Generator().manual_seed(6),
                  device="cpu", bidirectional=False)
    x = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (2, 6, 5)).astype(np.float32))
    runs = []
    for remat in (False, True):
        xt = x.clone().requires_grad_()
        out = bidirectional_rnn(tl, xt, cell, use_pallas=True, remat=remat)
        runs.append((out, *torch.autograd.grad(
            out.square().sum(), [xt, *tl.parameters()])))
    assert tuple(runs[0][0].shape) == (2, 6, 4)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.parametrize("cell,port_init,jax_init", [
    ("gru", gru_init, jax_gru_init), ("lstm", lstm_init, jax_lstm_init)])
def test_single_cell_init_matches_jax_layout(cell, port_init, jax_init):
    """`gru_init` / `lstm_init` build one cell with JAX's leaves and
    shapes, drawn from U(-1/sqrt(H), 1/sqrt(H)); a JAX cell loads into it
    leaf for leaf and runs as a one-direction layer."""
    ref = jax.tree_util.tree_map(
        np.asarray, jax_init(jax.random.PRNGKey(3), 7, 5))
    ours = port_init(7, 5, torch.Generator().manual_seed(3), device="cpu")
    shapes = {n: tuple(p.shape) for n, p in ours.named_parameters()}
    assert shapes == {k: v.shape for k, v in ref.items()}
    assert all(float(p.detach().abs().max()) <= 1 / np.sqrt(5)
               for p in ours.parameters())
    load_jax_params(ours, ref)
    x = np.random.default_rng(4).standard_normal((2, 6, 7)).astype(
        np.float32)
    want = jax_birnn([{"fwd": ref}], jnp.asarray(x), cell)
    layer = torch.nn.Module()
    layer.fwd = ours
    got = bidirectional_rnn([layer], torch.as_tensor(x), cell)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL)


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


def _gru_scan_inputs(t, b, h, seed, dtype):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(h)
    xp = rng.standard_normal((t, 2, b, 3 * h)).astype(np.float32)
    wh = rng.uniform(-s, s, (2, h, 3 * h)).astype(np.float32)
    bhn = rng.uniform(-s, s, (2, 1, h)).astype(np.float32)
    dhs = rng.standard_normal((t, 2, b, h)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_in = (jnp.asarray(xp, jdt), jnp.asarray(wh, jdt), jnp.asarray(bhn),
              jnp.asarray(dhs, jdt))
    torch_in = (torch.as_tensor(xp).to(dtype), torch.as_tensor(wh).to(dtype),
                torch.as_tensor(bhn), torch.as_tensor(dhs).to(dtype))
    return jax_in, torch_in


def _gru_scan_grads(xp, wh, bhn, dhs):
    """(dxp, dU, db_n) of <gru_scan(xp, wh, bhn), dhs> through the port's
    autograd.Function (K5's plain version on CPU tensors)."""
    leaves = [a.detach().requires_grad_() for a in (xp, wh, bhn)]
    hs = rnn_kernels.gru_scan(*leaves)
    return torch.autograd.grad(hs, leaves, dhs)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
def test_gru_scan_bwd_matches_pallas_vjp(dtype, tol):
    """K5's plain version (the gru_scan backward) against jax.vjp of
    pallas_gru_scan, whose backward is the Pallas `_gru_bwd_kernel` in
    interpret mode, at T=7, B=3, H=16. f32: summation order only, 1e-4.
    bf16: both round da_w to bf16 before the two products and keep dxp in
    bf16, so one flipped rounding carries back through the steps: 5e-2,
    the repo's bar for bf16 kernel gradients."""
    (jxp, jwh, jbhn, jdhs), tin = _gru_scan_inputs(7, 3, 16, 5, dtype)
    hs, vjp = jax.vjp(pallas_gru_scan, jxp, jwh, jbhn)
    ref = vjp(jdhs)
    ours = _gru_scan_grads(*tin)
    for name, g, r, arg in zip(("dxp", "dU", "db_n"), ours, ref, tin):
        assert g.dtype == arg.dtype and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


def test_gru_scan_bwd_matches_autograd_of_plain_loop():
    """The hand-written reverse loop against torch autograd through the
    forward loop `gru_scan_plain`, f32: summation order only, 1e-5."""
    _, (xp, wh, bhn, dhs) = _gru_scan_inputs(9, 4, 12, 6, torch.float32)
    leaves = [a.clone().requires_grad_() for a in (xp, wh, bhn)]
    ref = torch.autograd.grad(rnn_kernels.gru_scan_plain(*leaves), leaves,
                              dhs)
    for name, g, r in zip(("dxp", "dU", "db_n"), _gru_scan_grads(
            xp, wh, bhn, dhs), ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)


def test_birnn_kernel_route_grads_match_jax():
    """Gradients of a 2-layer BiGRU on the kernel route (input projection
    and direction flip as torch ops, the recurrence through gru_scan and
    K5's plain version) against jax.grad of the JAX stack with
    use_pallas=True (the Pallas forward and backward kernels in interpret
    mode), for every parameter and the input. f32 both sides: 1e-4."""
    jl, tl = _stack("gru", 9, 6, 2, seed=7)
    rng = np.random.default_rng(8)
    x = rng.standard_normal((3, 11, 9)).astype(np.float32)
    cot = rng.standard_normal((3, 11, 12)).astype(np.float32)

    def loss(params, xx):
        out = jax_birnn(params, xx, "gru", use_pallas=True)
        return jnp.sum(out * jnp.asarray(cot))

    ref_p, ref_x = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    out = bidirectional_rnn(tl, xt, "gru", use_pallas=True)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), atol=1e-4)
    grads = {n: p.grad for n, p in tl.named_parameters()}
    ref = dict(flatten_tree(jax.tree_util.tree_map(np.asarray, ref_p)))
    assert set(grads) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), want, atol=1e-4,
                                   rtol=1e-4, err_msg=name)


# ---------------------------------------------------------------------------
# LSTM: K7 and K8
# ---------------------------------------------------------------------------


def _lstm_scan_inputs(t, b, h, seed, dtype):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(h)
    xp = rng.standard_normal((t, 2, b, 4 * h)).astype(np.float32)
    wh = rng.uniform(-s, s, (2, h, 4 * h)).astype(np.float32)
    dhs = rng.standard_normal((t, 2, b, h)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jax_in = (jnp.asarray(xp, jdt), jnp.asarray(wh, jdt),
              jnp.asarray(dhs, jdt))
    torch_in = (torch.as_tensor(xp).to(dtype), torch.as_tensor(wh).to(dtype),
                torch.as_tensor(dhs).to(dtype))
    return jax_in, torch_in


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t,b,h", [(7, 2, 128), (9, 3, 20)])
def test_lstm_scan_plain_matches_pallas_lstm_scan(dtype, tol, t, b, h):
    """K7's plain version against the Pallas kernel body (interpret mode)
    on the same fused inputs: hs through `pallas_lstm_scan`, cs through
    `_lstm_fwd`. f32: summation order only, 1e-5. bf16: both carry h in
    bf16 and c in f32 and round the stored cs; one flipped bf16 rounding of
    h carries forward, 2e-2. H=20, B=3 is the ragged case (not a multiple
    of 32, nor of the TPU's 128 lanes, which interpret mode does not need)."""
    (jxp, jwh, _), (xp, wh, _) = _lstm_scan_inputs(t, b, h, 11, dtype)
    ref_hs = pallas_lstm_scan(jxp, jwh)
    _, ref_cs = _lstm_fwd(jxp, jwh)
    hs, cs = rnn_kernels.lstm_scan_plain(xp, wh)
    assert hs.dtype == cs.dtype == dtype
    assert tuple(hs.shape) == ref_hs.shape == (t, 2, b, h)
    np.testing.assert_allclose(hs.float().numpy(),
                               np.asarray(ref_hs, np.float32), atol=tol)
    np.testing.assert_allclose(cs.float().numpy(),
                               np.asarray(ref_cs, np.float32), atol=tol)
    torch.testing.assert_close(rnn_kernels.lstm_scan(xp, wh), hs)


def _lstm_scan_grads(xp, wh, dhs):
    """(dxp, dU) of <lstm_scan(xp, wh), dhs> through the port's
    autograd.Function (K8's plain version on CPU tensors)."""
    leaves = [a.detach().requires_grad_() for a in (xp, wh)]
    return torch.autograd.grad(rnn_kernels.lstm_scan(*leaves), leaves, dhs)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("t,b,h", [(7, 3, 16), (6, 3, 33)])
def test_lstm_scan_bwd_matches_pallas_vjp(dtype, tol, t, b, h):
    """K8's plain version (the lstm_scan backward) against jax.vjp of
    pallas_lstm_scan, whose backward is the Pallas `_lstm_bwd_kernel` in
    interpret mode. f32: summation order only, 1e-4. bf16: both round da to
    bf16 before the carry product and the dU sum and keep dxp in bf16, so
    one flipped rounding carries back through the steps: 5e-2, the repo's
    bar for bf16 kernel gradients. H=33, B=3 is the ragged case."""
    (jxp, jwh, jdhs), tin = _lstm_scan_inputs(t, b, h, 12, dtype)
    _, vjp = jax.vjp(pallas_lstm_scan, jxp, jwh)
    ref = vjp(jdhs)
    ours = _lstm_scan_grads(*tin)
    for name, g, r, arg in zip(("dxp", "dU"), ours, ref, tin):
        assert g.dtype == arg.dtype and tuple(g.shape) == r.shape, name
        np.testing.assert_allclose(g.float().numpy(),
                                   np.asarray(r, np.float32), atol=tol,
                                   rtol=tol, err_msg=name)


def test_lstm_scan_bwd_matches_autograd_of_plain_loop():
    """The hand-written reverse loop against torch autograd through the
    forward loop `lstm_scan_plain`, f32: summation order only, 1e-5."""
    _, (xp, wh, dhs) = _lstm_scan_inputs(9, 4, 12, 13, torch.float32)
    leaves = [a.clone().requires_grad_() for a in (xp, wh)]
    ref = torch.autograd.grad(rnn_kernels.lstm_scan_plain(*leaves)[0],
                              leaves, dhs)
    for name, g, r in zip(("dxp", "dU"), _lstm_scan_grads(xp, wh, dhs), ref):
        torch.testing.assert_close(g, r, atol=1e-5, rtol=1e-5, msg=name)


def test_bilstm_kernel_route_grads_match_jax():
    """Gradients of a 2-layer BiLSTM on the kernel route (input projection
    and direction flip as torch ops, the recurrence through lstm_scan and
    K8's plain version) against jax.grad of the JAX stack with
    use_pallas=True (the Pallas forward and backward kernels in interpret
    mode), for every parameter and the input. f32 both sides: 1e-4."""
    jl, tl = _stack("lstm", 9, 6, 2, seed=14)
    rng = np.random.default_rng(15)
    x = rng.standard_normal((3, 11, 9)).astype(np.float32)
    cot = rng.standard_normal((3, 11, 12)).astype(np.float32)

    def loss(params, xx):
        out = jax_birnn(params, xx, "lstm", use_pallas=True)
        return jnp.sum(out * jnp.asarray(cot))

    ref_p, ref_x = jax.grad(loss, argnums=(0, 1))(jl, jnp.asarray(x))
    xt = torch.as_tensor(x).requires_grad_()
    out = bidirectional_rnn(tl, xt, "lstm", use_pallas=True)
    (out * torch.as_tensor(cot)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(ref_x), atol=1e-4)
    grads = {n: p.grad for n, p in tl.named_parameters()}
    ref = dict(flatten_tree(jax.tree_util.tree_map(np.asarray, ref_p)))
    assert set(grads) == set(ref)
    for name, want in ref.items():
        np.testing.assert_allclose(grads[name].numpy(), want, atol=1e-4,
                                   rtol=1e-4, err_msg=name)


def test_bilstm_bf16_kernel_route_matches_jax():
    """A bf16 BiLSTM layer on the kernel route against JAX with
    use_pallas=True on the same bf16 input: both keep bf16 operands and h
    with f32 accumulation and an f32 cell state: 2e-2."""
    jl, tl = _stack("lstm", 6, 5, 1, seed=16)
    x = np.random.default_rng(17).standard_normal((2, 8, 6)).astype(
        np.float32)
    ref = jax_birnn(jl, jnp.asarray(x, jnp.bfloat16), "lstm",
                    use_pallas=True)
    out = bidirectional_rnn(tl, torch.as_tensor(x).bfloat16(), "lstm",
                            use_pallas=True)
    assert out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().detach().numpy(),
                               np.asarray(ref, np.float32), atol=2e-2)
