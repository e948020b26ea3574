"""The port's CUDA kernels against their plain versions, on the card.

Marked `cuda`: they skip without a CUDA device (the kernels have no CPU or
interpret mode; the CPU suite tests the plain versions against JAX). The
shapes are ragged on purpose — batch, time, hidden and embedding widths
that are not multiples of the kernels' tiles. On a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda.py

(`--noconftest`: the suite's conftest imports JAX, which the GPU machine
need not have; this file imports torch and numpy only.)
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA kernels run only there")
    from dl4ss_tpu_torch import resolve_device
    return resolve_device("cuda")


def _t(a, dev, dtype=torch.float32):
    return torch.as_tensor(np.asarray(a, np.float32), device=dev).to(dtype)


# K1 and K9 share one tile with two bodies (csrc/stft_tile.cuh): each shape
# names the body its frame length must take. N, hop and the batch are chosen
# so that T is no multiple of the FFT body's 8 frames per block (the last
# block's tile is partial) and rows past the first do not start on 16-byte
# boundaries; B=16 of 5 s at 8 kHz is the serving batch.
STFT_SHAPES = [(1, 3100, 256, 128, "fft"), (3, 777, 64, 16, "fft"),
               (2, 1000, 256, 96, "fft"), (3, 333, 32, 8, "fft"),
               (1, 5203, 512, 128, "fft"), (2, 9001, 2048, 512, "fft"),
               (2, 1001, 96, 48, "direct"), (1, 5001, 1000, 250, "direct"),
               (16, 40000, 96, 48, "direct"), (16, 40000, 256, 128, "fft")]


def _ran(k, name, body):
    return k.BODY_LAUNCHES[name, body]


@pytest.mark.parametrize("b,n,length,hop,body", STFT_SHAPES)
@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
def test_k1_stft_features(dev, request, b, n, length, hop, body, feat_dtype):
    if (b, n, length, feat_dtype) == (16, 40000, 256, torch.bfloat16):
        # some of the serving batch's bf16 magnitudes land one step of 2^-7
        # of their value from the plain version's, past the bar below
        request.applymarker(pytest.mark.xfail(
            strict=True, reason="the L <= 256 bf16 bar of 2^-8 is below one "
            "bf16 step of some magnitudes at B=16, N=40000"))
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import stft_kernels as k
    from dl4ss_tpu_torch.ops.stft import reflect_pad
    x = _t(np.random.default_rng(0).uniform(-1, 1, (b, n)), dev)
    xpad = reflect_pad(x, length // 2).contiguous()
    before = _ran(k, "stft_features", body), cuda_lib.LAUNCHES["stft_features"]
    got = k.stft_features_cuda(xpad, length, hop, "hann", feat_dtype)
    assert k.stft_body(length, hop) == body
    assert (_ran(k, "stft_features", body),
            cuda_lib.LAUNCHES["stft_features"]) == (before[0] + 1,
                                                    before[1] + 1)
    ref = k.stft_features_plain(xpad, length, hop, "hann", feat_dtype)
    # a bf16 magnitude may land one step from the plain version's: a step
    # is 2^-8 to 2^-7 of the value, and past L=256 some fall in the upper
    # half of that range
    step = 2 ** -8 if length <= 256 else 2 ** -7
    for g, r in zip(got, ref):
        assert g.shape == r.shape and g.dtype == r.dtype
        torch.testing.assert_close(g.float(), r.float(), atol=1e-4,
                                   rtol=0 if g.dtype == torch.float32
                                   else step)


@pytest.mark.parametrize("b,n,length,hop", [(1, 3001, 256, 128),
                                           (3, 777, 64, 16),
                                           (2, 1000, 256, 96),
                                           (2, 9001, 2048, 512),
                                           (16, 40000, 256, 128)])
def test_k1_k9_fft_body_against_its_mirror_and_the_direct_body(
        dev, b, n, length, hop):
    """The FFT body, partial last tile included, against its CPU mirror run
    on the card (1e-5: the same steps, FMA contraction apart) and against
    the direct body forced on the same power-of-two shape (1e-4)."""
    from dl4ss_tpu_torch.ops import stft_kernels as k
    x = _t(np.random.default_rng(16).uniform(-1, 1, (b, n)), dev)
    before = {key: _ran(k, *key) for key in (
        ("stft_ri", "fft"), ("stft_ri", "direct"), ("stft_features", "fft"))}
    got = k.stft_ri_cuda(x, length, hop, "hann", body="fft")
    torch.testing.assert_close(got, k.stft_fft_mirror(x, length, hop, "hann"),
                               atol=1e-5, rtol=0)
    direct = k.stft_ri_cuda(x, length, hop, "hann", body="direct")
    torch.testing.assert_close(got, direct, atol=1e-4, rtol=0)
    _, re, im = k.stft_features_cuda(x, length, hop, "hann", torch.float32)
    assert torch.equal(got, torch.cat([re, im], dim=-1))
    assert {key: _ran(k, *key) - n0 for key, n0 in before.items()} == {
        ("stft_ri", "fft"): 1, ("stft_ri", "direct"): 1,
        ("stft_features", "fft"): 1}


@pytest.mark.parametrize("length,hop", [(16, 8), (96, 48), (256, 300),
                                        (1000, 250)])
def test_k1_k9_fft_body_refuses_what_the_rule_sends_elsewhere(dev, length,
                                                              hop):
    """Every shape that the rule sends to the direct body the FFT body
    refuses, rather than run wrongly or run another body; the direct body
    takes it."""
    from dl4ss_tpu_torch.ops import stft_kernels as k
    assert k.stft_body(length, hop) == "direct"
    x = _t(np.random.default_rng(17).uniform(-1, 1, (1, 3 * length + hop)),
           dev)
    with pytest.raises(RuntimeError, match="stft_ri failed"):
        k.stft_ri_cuda(x, length, hop, "hann", body="fft")
    torch.testing.assert_close(k.stft_ri_cuda(x, length, hop, "hann"),
                               k.stft_ri_plain(x, length, hop, "hann"),
                               atol=1e-4, rtol=0)


@pytest.mark.parametrize("t,b,h", [(7, 1, 37), (5, 17, 300), (3, 2, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_k2_gru_fwd(dev, t, b, h, dtype, tol):
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(1)
    s = 1 / np.sqrt(h)
    xp = _t(rng.standard_normal((t, 2, b, 3 * h)), dev, dtype)
    wh = _t(rng.uniform(-s, s, (2, h, 3 * h)), dev, dtype)
    bhn = _t(rng.uniform(-s, s, (2, 1, h)), dev)
    torch.testing.assert_close(k.gru_scan_cuda(xp, wh, bhn).float(),
                               k.gru_scan_plain(xp, wh, bhn).float(),
                               atol=tol, rtol=0)


# K3 / K6 shapes: ragged T (313 leaves a 57-row last unit; 5 and 33 leave
# one unit), odd B (the last item's second unit lies past the batch), D of
# 24, 37 (padded to 40 by the wrapper), 40 and 600, E of 5 (13 groups a
# tile), 16, 20, 50 and 256 (one group a tile), K of 1, 2 and 3; full width
# at B=1 and B=16
MASKHEAD_SHAPES = [(1, 70, 24, 13, 5, 3), (2, 129, 600, 129, 50, 2),
                   (3, 5, 40, 7, 16, 1), (2, 33, 37, 10, 20, 2),
                   (1, 313, 600, 129, 50, 2), (16, 313, 600, 129, 50, 2),
                   (3, 313, 64, 3, 256, 2), (3, 100, 600, 129, 50, 3)]


def _maskhead_args(dev, b, t, d, f, e, k, w_dtype=torch.bfloat16, seed=2):
    rng = np.random.default_rng(seed)
    s = 1 / np.sqrt(d)
    return (_t(rng.uniform(-1, 1, (b, t, d)), dev, torch.bfloat16),
            _t(rng.uniform(-s, s, (d, f * e)), dev, w_dtype),
            _t(rng.uniform(-s, s, f * e), dev),
            _t(rng.standard_normal((b, k, e)), dev, torch.bfloat16))


@pytest.mark.parametrize("b,t,d,f,e,k", MASKHEAD_SHAPES)
@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_k3_maskhead_fwd(dev, b, t, d, f, e, k, out_dtype):
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    rng = np.random.default_rng(2)
    s = 1 / np.sqrt(d)
    args = (_t(rng.uniform(-1, 1, (b, t, d)), dev, torch.bfloat16),
            _t(rng.uniform(-s, s, (d, f * e)), dev, torch.bfloat16),
            _t(rng.uniform(-s, s, f * e), dev),
            _t(rng.standard_normal((b, k, e)), dev, torch.bfloat16),
            f, e, out_dtype)
    got = m.fused_dot_masks_cuda(*args)
    assert got.shape == (b, k, t, f) and got.dtype == out_dtype
    torch.testing.assert_close(got.float(),
                               m.fused_dot_masks_plain(*args).float(),
                               atol=2e-2, rtol=0)
    assert torch.equal(got, m.fused_dot_masks_cuda(*args))


def test_k3_packs_w_once_per_version(dev):
    """W is packed on its first use, reused while it is unchanged, and
    repacked after an in-place update."""
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    rng = np.random.default_rng(5)
    b, t, d, f, e, k = 2, 20, 48, 9, 12, 2
    h = _t(rng.uniform(-1, 1, (b, t, d)), dev, torch.bfloat16)
    w = _t(rng.uniform(-0.2, 0.2, (d, f * e)), dev)
    bias = _t(rng.uniform(-0.2, 0.2, f * e), dev)
    q = _t(rng.standard_normal((b, k, e)), dev, torch.bfloat16)
    args = (h, w, bias, q, f, e, torch.float32)
    before = cuda_lib.LAUNCHES["maskhead_pack"]
    m.fused_dot_masks_cuda(*args)
    m.fused_dot_masks_cuda(*args)
    assert cuda_lib.LAUNCHES["maskhead_pack"] == before + 1
    w.mul_(-1.0)
    got = m.fused_dot_masks_cuda(*args)
    assert cuda_lib.LAUNCHES["maskhead_pack"] == before + 2
    torch.testing.assert_close(got, m.fused_dot_masks_plain(*args),
                               atol=2e-2, rtol=0)


# K4 and K10 share one tile with two bodies (csrc/istft_tile.cuh); every
# shape here is one that both bodies take. T of 1, 8 (the FFT body's hops
# per block), 9 and 17 put the edges of its tiles, and of the halo it
# computes again, at every place; B=1 leaves most of a batch's blocks out.
# B=16 and B=1 at T=313 are a serving batch and a request.
K4_SHAPES = [(1, 2, 9, 256, 128), (2, 3, 13, 64, 16), (2, 1, 6, 256, 64),
             (1, 2, 1, 256, 128), (1, 2, 8, 256, 128), (2, 2, 17, 32, 32),
             (3, 2, 313, 256, 128), (1, 1, 9, 512, 128),
             (16, 2, 313, 256, 128), (1, 2, 313, 256, 128)]


@pytest.mark.parametrize("b,k,t,length,hop", K4_SHAPES)
@pytest.mark.parametrize("mask_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("body", ["fft", "direct"])
def test_k4_masked_istft(dev, b, k, t, length, hop, mask_dtype, body):
    """K4 on the body named against its plain version (1e-4); the FFT body
    also against its CPU mirror run on the card (1e-5: the same steps, FMA
    contraction apart) and against a second call of itself (bit-equal:
    every sample is summed in the same order)."""
    from dl4ss_tpu_torch.ops import stft_kernels as s
    rng = np.random.default_rng(3)
    f = length // 2 + 1
    re, im = (_t(rng.standard_normal((b, t, f)), dev) for _ in range(2))
    masks = _t(rng.uniform(0, 1, (b, k, t, f)), dev, mask_dtype)
    args = (re, im, masks, length, hop, "hann")
    before = _ran(s, "masked_istft", body)
    got = s.masked_ola_cuda(*args, body=body)
    assert _ran(s, "masked_istft", body) == before + 1
    torch.testing.assert_close(got, s.masked_ola_plain(*args), atol=1e-4,
                               rtol=0)
    if body == "fft":
        torch.testing.assert_close(
            got, s.istft_fft_mirror(re, im, length, hop, "hann", masks),
            atol=1e-5, rtol=0)
        assert torch.equal(got, s.masked_ola_cuda(*args, body=body))
    # the public wrapper, on the rule's body (the FFT one for every shape
    # here), normalised, trimmed and padded past (T-1)*hop; not at hop = L,
    # where win^2 alone is the normaliser and, near 0 inside the output,
    # amplifies either side's round-off past the bar
    assert s.istft_body(length, hop) == "fft"
    n_out = (t - 1) * hop + 10
    if hop < length:
        torch.testing.assert_close(
            s.masked_istft(re, im, masks, length, hop, length=n_out).cpu(),
            s.masked_istft(re.cpu(), im.cpu(), masks.cpu(), length, hop,
                           length=n_out), atol=1e-4, rtol=0)


@pytest.mark.parametrize("b,k,t,length,hop", [(2, 2, 20, 1024, 512),
                                              (1, 2, 11, 2048, 256),
                                              (1, 1, 5, 2048, 2048)])
def test_k4_k10_fft_body_at_long_frames(dev, b, k, t, length, hop):
    """The FFT body where L/2 no longer fits 8 warps' buffers (fewer warps,
    several frames each) and up to R=8 frames cover a sample: K4 and K10
    against their plain versions (1e-4) and the mirror (1e-5)."""
    from dl4ss_tpu_torch.ops import stft_kernels as s
    rng = np.random.default_rng(18)
    f = length // 2 + 1
    re, im = (_t(rng.standard_normal((b, t, f)), dev) for _ in range(2))
    masks = _t(rng.uniform(0, 1, (b, k, t, f)), dev)
    got = s.masked_ola_cuda(re, im, masks, length, hop, "hann")
    torch.testing.assert_close(
        got, s.masked_ola_plain(re, im, masks, length, hop, "hann"),
        atol=1e-4, rtol=0)
    torch.testing.assert_close(
        got, s.istft_fft_mirror(re, im, length, hop, "hann", masks),
        atol=1e-5, rtol=0)
    ri = torch.cat([re, im], dim=-1).contiguous()
    got = s.istft_ola_cuda(ri, length, hop, "hann")
    torch.testing.assert_close(
        got, s.istft_ola_plain(ri, length, hop, "hann"), atol=1e-4, rtol=0)
    torch.testing.assert_close(
        got, s.istft_fft_mirror(re, im, length, hop, "hann"), atol=1e-5,
        rtol=0)


@pytest.mark.parametrize("length,hop", [(96, 48), (1000, 250), (256, 16),
                                        (256, 96)])
def test_k4_k10_fft_body_refuses_what_the_rule_sends_elsewhere(dev, length,
                                                                hop):
    """Every shape that the rule sends to the direct body (no power of two,
    more than 8 frames over a sample, a hop that does not divide L) the FFT
    body refuses, rather than run wrongly or run another body, and counts
    no launch; the direct body takes it."""
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import stft_kernels as s
    assert s.istft_body(length, hop) == "direct"
    rng = np.random.default_rng(19)
    f = length // 2 + 1
    re, im = (_t(rng.standard_normal((1, 7, f)), dev) for _ in range(2))
    masks = _t(rng.uniform(0, 1, (1, 2, 7, f)), dev)
    ri = torch.cat([re, im], dim=-1).contiguous()
    before = dict(s.BODY_LAUNCHES), dict(cuda_lib.LAUNCHES)
    with pytest.raises(RuntimeError, match="masked_istft failed"):
        s.masked_ola_cuda(re, im, masks, length, hop, "hann", body="fft")
    with pytest.raises(RuntimeError, match="istft_ri failed"):
        s.istft_ola_cuda(ri, length, hop, "hann", body="fft")
    assert (dict(s.BODY_LAUNCHES), dict(cuda_lib.LAUNCHES)) == before
    torch.testing.assert_close(
        s.masked_ola_cuda(re, im, masks, length, hop, "hann"),
        s.masked_ola_plain(re, im, masks, length, hop, "hann"), atol=1e-4,
        rtol=0)
    torch.testing.assert_close(s.istft_ola_cuda(ri, length, hop, "hann"),
                               s.istft_ola_plain(ri, length, hop, "hann"),
                               atol=1e-4, rtol=0)
    assert _ran(s, "masked_istft", "direct") == before[0].get(
        ("masked_istft", "direct"), 0) + 1


def test_wrappers_route_cuda_tensors_to_the_kernels(dev):
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.models import init_separator
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.serve import separate_waveforms
    cfg = preset("synth_tiny").replace(use_pallas_rnn=True,
                                       use_pallas_stft=True,
                                       use_pallas_maskhead=True)
    model = init_separator(cfg, torch.Generator().manual_seed(0), dev)
    wav = _t(np.random.default_rng(4).uniform(-1, 1, (2, cfg.max_len)), dev)
    spk = torch.tensor([[0, 1], [2, 3]], device=dev)
    before = dict(cuda_lib.LAUNCHES)
    out = separate_waveforms(model, wav, cfg, spk, length=cfg.max_len)
    assert out.shape == (2, 2, cfg.max_len)
    for name in cuda_lib.SERVING_KERNELS:
        assert cuda_lib.LAUNCHES[name] > before.get(name, 0), name
    plain = separate_waveforms(
        model, wav, cfg.replace(use_pallas_rnn=False, use_pallas_stft=False,
                                use_pallas_maskhead=False), spk,
        length=cfg.max_len)
    assert float((out - plain).norm() / plain.norm()) < 2e-2


def _rel(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


def _check_bodies(k, name, cuda, plain, args, h, tol, body, outs,
                  rtol=None):
    """One body of K2, K5, K7 or K8 against the plain version. The resident
    and cluster bodies must refuse a width their registers cannot hold
    (H > 304), the tiled body one past its shared memory (K2 and K7 at
    H=600), the wide body every kernel but K7, the cluster and tiled bodies
    every backward, and nothing may fall back: no launch is counted; a
    batch past one launch's grid the resident and tiled bodies walk in
    chunks, the cluster body in waves of clusters. The stepwise body takes
    every shape that fits its shared memory, the wide body every K7 shape
    the card holds (forced below H=305 too). The resident, cluster, wide
    and tiled bodies are also held to the stepwise one, the cluster body
    bit for bit to the resident one (the same column split), and two
    back-to-back calls on one stream must agree bit for bit: that guards
    the barrier's tickets, which each call gets zeroed, and the cluster
    body's inboxes. `rtol` defaults to `tol`."""
    from dl4ss_tpu_torch.ops import cuda_lib
    rtol = tol if rtol is None else rtol
    backward = name.endswith("_bwd")
    rule = k.default_body(args[0].device, name, args[0].dtype, h,
                          args[0].shape[2], args[0].shape[1])
    if ((body in ("resident", "cluster", "tiled")
         and h > k.RESIDENT_MAX_HIDDEN)
            or (body == "wide" and name != "lstm_fwd")
            or (body in ("cluster", "tiled") and backward)):
        if h > k.RESIDENT_MAX_HIDDEN:
            assert rule == ("wide" if name == "lstm_fwd" else "stepwise")
        elif backward:
            assert rule in ("resident", "stepwise")
        before = dict(k.BODY_LAUNCHES), dict(cuda_lib.LAUNCHES)
        with pytest.raises(RuntimeError, match=f"{name} failed"):
            cuda(*args, body=body)
        torch.cuda.synchronize()
        assert (dict(k.BODY_LAUNCHES), dict(cuda_lib.LAUNCHES)) == before
        body = None             # the default call then runs the rule's body
    before = k.BODY_LAUNCHES[name, body or rule], cuda_lib.LAUNCHES[name]
    got = cuda(*args, body=body)
    assert (k.BODY_LAUNCHES[name, body or rule],
            cuda_lib.LAUNCHES[name]) == (before[0] + 1, before[1] + 1)

    def outputs(fn, **kw):      # K2 returns hs alone, the others a tuple
        res = fn(*args, **kw)
        return (res,) if isinstance(res, torch.Tensor) else res
    got = (got,) if isinstance(got, torch.Tensor) else got
    for what, g, r in zip(outs, got, outputs(plain)):
        assert g.shape == r.shape and g.dtype == r.dtype, what
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=rtol,
                                   msg=what)
    if body in ("resident", "wide", "cluster", "tiled"):
        for what, g, g2, r in zip(outs, got, outputs(cuda, body=body),
                                  outputs(cuda, body="stepwise")):
            assert torch.equal(g, g2), what
            torch.testing.assert_close(g.float(), r.float(), atol=tol,
                                       rtol=rtol, msg=what)
    if body == "cluster":
        for what, g, r in zip(outs, got, outputs(cuda, body="resident")):
            assert torch.equal(g, r), what


# (t, b, h): B=21 and 32 at H=300 walk the resident body in two launches of
# at most 20 rows on 132 SMs; H=37 fits B=32 in one; B=1 and 21 leave
# ragged row tiles; T=313 at B=1, 16 and 32 are the paths' full shapes
FWD_SHAPES = [(7, 1, 37), (6, 16, 37), (5, 21, 37), (4, 32, 37),
              (5, 1, 300), (5, 16, 300), (4, 21, 300), (3, 32, 300),
              (313, 1, 300), (313, 16, 300), (313, 32, 300)]


@pytest.mark.parametrize("t,b,h", FWD_SHAPES + [(3, 5, 600)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("body", ["resident", "stepwise", "cluster",
                                  "tiled"])
def test_k2_gru_fwd_bodies(dev, t, b, h, dtype, tol, body):
    """K2, all four bodies, against its plain version. f32: summation
    order only (1e-4). bf16: h is carried in bf16, so an order difference
    can flip one rounding and carry it on through the steps (2e-2, the
    repo's bar for bf16 forward kernels). H=600 is past the resident,
    cluster and tiled bodies."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(16)
    s = 1 / np.sqrt(h)
    args = (_t(0.5 * rng.standard_normal((t, 2, b, 3 * h)), dev, dtype),
            _t(rng.uniform(-s, s, (2, h, 3 * h)), dev, dtype),
            _t(rng.uniform(-s, s, (2, 1, h)), dev))
    _check_bodies(k, "gru_fwd", k.gru_scan_cuda, k.gru_scan_plain, args, h,
                  tol, body, ("hs",), rtol=0)


# K7's wide body: B=1, a ragged B=5, B=16 (also at T=313, the TDAA
# classifier's request) and the rule's largest batch at H=600 (the TDAA
# classifier width) and at H=660, the widest whose blocks (2 * 66) fit the
# 132 SMs
WIDE_SHAPES = [(3, 1, 600), (3, 5, 600), (3, 16, 600), (2, 48, 600),
               (2, 1, 660), (2, 48, 660), (313, 16, 600)]


@pytest.mark.parametrize("t,b,h", FWD_SHAPES + WIDE_SHAPES)
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("body", ["resident", "stepwise", "wide", "cluster",
                                  "tiled"])
def test_k7_lstm_fwd_bodies(dev, t, b, h, dtype, tol, body):
    """K7, all five bodies, hs and cs against its plain version;
    tolerances as for K2. Past H=304 the resident, cluster and tiled bodies
    refuse and the rule names the wide one; below it the wide body runs
    when forced."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(17)
    s = 1 / np.sqrt(h)
    args = (_t(0.5 * rng.standard_normal((t, 2, b, 4 * h)), dev, dtype),
            _t(rng.uniform(-s, s, (2, h, 4 * h)), dev, dtype))
    _check_bodies(k, "lstm_fwd", k.lstm_scan_cuda, k.lstm_scan_plain, args,
                  h, tol, body, ("hs", "cs"), rtol=0)


# one-direction layers (D = 1): at H=300 one launch of the resident body
# takes 40 rows on 132 SMs (10 tiles of 13 blocks), so B=44 takes two; the
# LSTM at H=600 (the classifier's width, which no GRU has) takes the wide
# body forward (60 blocks)
@pytest.mark.parametrize("cell,t,b,h", [
    (cell, *shape) for cell in ("gru", "lstm")
    for shape in ((7, 1, 37), (5, 17, 300), (3, 44, 300))]
    + [("lstm", 3, 16, 600)])
@pytest.mark.parametrize("body", ["resident", "stepwise", "wide", "cluster"])
def test_one_direction_kernels(dev, t, b, h, cell, body):
    """K2 and K5 (GRU) or K7 and K8 (LSTM) with D = 1, the layout of a
    one-direction layer, every body, against the plain versions in f32
    (summation order only: 1e-4), the backward on the forward's own
    states."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(18)
    s = 1 / np.sqrt(h)
    gates = 3 if cell == "gru" else 4
    xp = _t(0.5 * rng.standard_normal((t, 1, b, gates * h)), dev)
    wh = _t(rng.uniform(-s, s, (1, h, gates * h)), dev)
    dhs = _t(rng.standard_normal((t, 1, b, h)), dev)
    zeros = torch.zeros((1, 1, b, h), device=dev)
    if cell == "gru":
        bhn = _t(rng.uniform(-s, s, (1, 1, h)), dev)
        _check_bodies(k, "gru_fwd", k.gru_scan_cuda, k.gru_scan_plain,
                      (xp, wh, bhn), h, 1e-4, body, ("hs",), rtol=0)
        hs = k.gru_scan_plain(xp, wh, bhn)
        _check_bodies(k, "gru_bwd", k.gru_scan_bwd_cuda,
                      k.gru_scan_bwd_plain,
                      (xp, wh, bhn, torch.cat([zeros, hs[:-1]]), dhs), h,
                      1e-4, body, ("dxp", "dU", "db_n"))
        return
    _check_bodies(k, "lstm_fwd", k.lstm_scan_cuda, k.lstm_scan_plain,
                  (xp, wh), h, 1e-4, body, ("hs", "cs"), rtol=0)
    hs, cs = k.lstm_scan_plain(xp, wh)
    _check_bodies(k, "lstm_bwd", k.lstm_scan_bwd_cuda, k.lstm_scan_bwd_plain,
                  (xp, wh, torch.cat([zeros, hs[:-1]]),
                   torch.cat([zeros, cs[:-1]]), cs, dhs), h, 1e-4, body,
                  ("dxp", "dU"))


# the tiled body (B > 40 at H <= 304): one row tile past the resident
# body's last batch (B=41), two tiles (64), the serving cell's batch (256:
# 16 groups of 8 blocks, 128 of the 132 SMs) and one row past it (257: a
# second launch of one ragged tile), over T=313 and T=1 (no product at all)
TILED_SHAPES = [(t, b) for b in (41, 64, 256, 257) for t in (313, 1)]


@pytest.mark.parametrize("name", ["gru_fwd", "lstm_fwd"])
@pytest.mark.parametrize("t,b", TILED_SHAPES)
@pytest.mark.parametrize("d", [2, 1])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_k2_k7_tiled_body(dev, name, t, b, d, dtype, tol):
    """K2 and K7's tiled body at H=300, both directions and one, against
    the plain version and the stepwise body at the bars of the other
    bodies, and two calls bit for bit (`_check_bodies`), forced where the
    rule names another body: the resident one where it holds the batch in
    its two launches (one direction at B=41 and 64: 40 rows a launch), or
    K7's stepwise one below TILED_FROM (B=41)."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(20)
    h = 300
    gates = 3 if name == "gru_fwd" else 4
    s = 1 / np.sqrt(h)
    args = (_t(0.5 * rng.standard_normal((t, d, b, gates * h)), dev, dtype),
            _t(rng.uniform(-s, s, (d, h, gates * h)), dev, dtype))
    if name == "gru_fwd":
        args += (_t(rng.uniform(-s, s, (d, 1, h)), dev),)
    resident = (len(k.resident_chunks(b, h, d, k._sms(dev)))
                <= k.RESIDENT_MAX_CHUNKS["forward"])
    assert k.default_body(dev, name, dtype, h, b, d) == (
        "resident" if resident else
        "tiled" if b >= k.TILED_FROM[gates] else "stepwise")
    cuda, plain, outs = ((k.gru_scan_cuda, k.gru_scan_plain, ("hs",))
                         if name == "gru_fwd" else
                         (k.lstm_scan_cuda, k.lstm_scan_plain, ("hs", "cs")))
    _check_bodies(k, name, cuda, plain, args, h, tol, "tiled", outs,
                  rtol=0)


def test_k2_default_call_at_the_bulk_serving_shape(dev):
    """The serving stack's two BiGRU layers at the bulk cell's shape (T=313
    frames of 5 s, B=256, H=300) by default: one tiled launch of K2 a
    layer and no stepwise one, and the stack's output within the f32 bar
    of the plain route's."""
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    from dl4ss_tpu_torch.ops.rnn import bidirectional_rnn, rnn_init
    gen = torch.Generator().manual_seed(21)
    layers = rnn_init("gru", 129, 300, 2, gen, device=dev)
    x = torch.randn((256, 313, 129), generator=gen).to(dev)
    before = dict(k.BODY_LAUNCHES), cuda_lib.LAUNCHES["gru_fwd"]
    with torch.inference_mode():
        got = bidirectional_rnn(layers, x, "gru", use_pallas=True)
        ref = bidirectional_rnn(layers, x, "gru")
    torch.cuda.synchronize()
    ran = {key: n - before[0].get(key, 0) for key, n in
           k.BODY_LAUNCHES.items() if key[0] == "gru_fwd"}
    assert ran.get(("gru_fwd", "tiled")) == 2
    assert ran.get(("gru_fwd", "stepwise"), 0) == 0
    assert cuda_lib.LAUNCHES["gru_fwd"] - before[1] == 2
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)


def test_k2_k7_refuse_a_drifted_ticket_count(dev, monkeypatch):
    """The forward wrappers size the ticket body's tickets from their own
    copy of the rows per barrier group: a copy that has drifted is
    refused."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    xp = torch.zeros((2, 2, 5, 24), device=dev)
    wh = torch.zeros((2, 8, 24), device=dev)
    k.gru_scan_cuda(xp, wh, torch.zeros((2, 1, 8), device=dev),
                    body="resident")
    monkeypatch.setattr(k, "RESIDENT_ROWS", 8)
    with pytest.raises(RuntimeError, match="gru_fwd failed"):
        k.gru_scan_cuda(xp, wh, torch.zeros((2, 1, 8), device=dev),
                        body="resident")
    with pytest.raises(RuntimeError, match="lstm_fwd failed"):
        k.lstm_scan_cuda(torch.zeros((2, 2, 5, 32), device=dev),
                         torch.zeros((2, 8, 32), device=dev),
                         body="resident")
    torch.cuda.synchronize()


@pytest.mark.parametrize("name", ["gru_fwd", "lstm_fwd"])
@pytest.mark.parametrize("b", [1, 4, 16])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 2e-2)])
def test_k2_k7_cluster_body_at_the_path_shapes(dev, name, b, dtype, tol):
    """The cluster body at the paths' shape (T=313, H=300) and batches: a
    serving request (B=1), 4 rows (one row tile) and B=16 (the training
    step and the TDAA serving batch). On the card the rule names it (every
    cluster of the launch fits at once: 16 blocks a cluster up to B=12, 9
    from there to B=16 on an H100) and counts one launch of it a layer; it
    holds the plain version to the bars of the other bodies, equals the
    ticket body bit for bit (the same column split and order), two calls
    equal each other, and a CUDA graph's replay equals the eager call."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(19)
    t, h = 313, 300
    gates = 3 if name == "gru_fwd" else 4
    s = 1 / np.sqrt(h)
    args = (_t(0.5 * rng.standard_normal((t, 2, b, gates * h)), dev, dtype),
            _t(rng.uniform(-s, s, (2, h, gates * h)), dev, dtype))
    if name == "gru_fwd":
        args += (_t(rng.uniform(-s, s, (2, 1, h)), dev),)
    cuda, plain = ((k.gru_scan_cuda, k.gru_scan_plain) if name == "gru_fwd"
                   else (k.lstm_scan_cuda, k.lstm_scan_plain))

    def outputs(fn, **kw):
        res = fn(*args, **kw)
        return (res,) if isinstance(res, torch.Tensor) else tuple(res)
    assert k.default_body(dev, name, dtype, h, b) == "cluster"
    before = k.BODY_LAUNCHES[name, "cluster"]
    got = outputs(cuda)
    assert k.BODY_LAUNCHES[name, "cluster"] == before + 1
    for g, r in zip(got, outputs(plain)):
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=0)
    for g, r, again in zip(got, outputs(cuda, body="resident"),
                           outputs(cuda)):
        assert torch.equal(g, r) and torch.equal(g, again)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        outputs(cuda)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = outputs(cuda)
    graph.replay()
    torch.cuda.synchronize()
    for g, c in zip(got, captured):
        assert torch.equal(g, c)


# (4, 24, 300): 2 * 6 groups of 13 blocks are more than the card's SMs, so
# the resident body runs in two launches; T=313 at B=16 (the training
# shape), 32 and 128 (two and seven launches)
@pytest.mark.parametrize("t,b,h", [(7, 1, 37), (5, 17, 300), (3, 2, 8),
                                   (12, 3, 45), (4, 24, 300), (313, 16, 300),
                                   (313, 32, 300), (313, 128, 300)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("body", ["resident", "stepwise"])
def test_k5_gru_bwd(dev, t, b, h, dtype, tol, body):
    """K5, both bodies, against its plain version on the forward's own hs.
    f32: only the summation order and the order of the coefficient
    products differ (1e-4). bf16: da_w is rounded to bf16 before both
    products, so an order difference can flip one rounding and carry it
    back through the steps (5e-2, the repo's gradient bar for bf16
    kernels)."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(6)
    s = 1 / np.sqrt(h)
    xp = _t(rng.standard_normal((t, 2, b, 3 * h)), dev, dtype)
    wh = _t(rng.uniform(-s, s, (2, h, 3 * h)), dev, dtype)
    bhn = _t(rng.uniform(-s, s, (2, 1, h)), dev)
    hs = k.gru_scan_cuda(xp, wh, bhn)
    hprev = torch.cat([torch.zeros_like(hs[:1]), hs[:-1]])
    dhs = _t(rng.standard_normal((t, 2, b, h)), dev, dtype)
    _check_bodies(k, "gru_bwd", k.gru_scan_bwd_cuda, k.gru_scan_bwd_plain,
                  (xp, wh, bhn, hprev, dhs), h, tol, body,
                  ("dxp", "dU", "db_n"))


def test_k5_k8_refuse_an_unknown_body(dev):
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    xp = torch.zeros((2, 2, 1, 24), device=dev)
    wh = torch.zeros((2, 8, 24), device=dev)
    h = torch.zeros((2, 2, 1, 8), device=dev)
    with pytest.raises(KeyError):
        k.gru_scan_bwd_cuda(xp, wh, torch.zeros((2, 1, 8), device=dev), h, h,
                            body="persistent")


@pytest.mark.parametrize("constant,value", [("DU_SPLIT", 8),
                                            ("RESIDENT_ROWS", 8)])
def test_k5_refuses_scratch_of_another_size(dev, monkeypatch, constant,
                                            value):
    """The wrapper sizes the dU partials and the tickets from its own copies
    of the kernels' constants and tells the library the sizes: with a copy
    that has drifted the library refuses the call instead of writing past
    the scratch."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    xp = torch.zeros((2, 2, 5, 24), device=dev)
    wh = torch.zeros((2, 8, 24), device=dev)
    h = torch.zeros((2, 2, 5, 8), device=dev)
    bhn = torch.zeros((2, 1, 8), device=dev)
    k.gru_scan_bwd_cuda(xp, wh, bhn, h, h)
    monkeypatch.setattr(k, constant, value)
    with pytest.raises(RuntimeError, match="gru_bwd failed"):
        k.gru_scan_bwd_cuda(xp, wh, bhn, h, h)
    torch.cuda.synchronize()


@pytest.mark.parametrize("b,t,d,f,e,k", MASKHEAD_SHAPES)
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_k6_maskhead_bwd(dev, b, t, d, f, e, k, w_dtype):
    """K6 against its plain version. dacc: the recomputed g differs from
    the plain matmul by f32 summation order, which can flip one bf16
    rounding of de or dacc (one bf16 step, 2^-8 relative): 1e-2. dq sums
    bf16-rounded column sums over every tile: 1e-2 relative L2."""
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    rng = np.random.default_rng(7)
    s = 1 / np.sqrt(d)
    h = _t(rng.uniform(-1, 1, (b, t, d)), dev, torch.bfloat16)
    w = _t(rng.uniform(-s, s, (d, f * e)), dev, w_dtype)
    bias = _t(rng.uniform(-s, s, f * e), dev)
    q = _t(rng.standard_normal((b, k, e)), dev, torch.bfloat16)
    masks = m.fused_dot_masks_cuda(h, w, bias, q, f, e, torch.bfloat16)
    dout = _t(rng.standard_normal((b, k, t, f)), dev, torch.bfloat16)
    args = (h, w, bias, q, masks, dout, f, e)
    (dacc, dq, db), (dacc_p, dq_p, db_p) = m.fused_dot_masks_bwd_cuda(*args), \
        m.fused_dot_masks_bwd_plain(*args)
    assert dacc.shape == dacc_p.shape == (b, t, f * e)
    assert dacc.dtype == dacc_p.dtype == torch.bfloat16
    assert dq.shape == dq_p.shape == (b, k, e) and dq.dtype == torch.float32
    assert db.shape == (f * e,) and db.dtype == torch.float32
    torch.testing.assert_close(dacc.float(), dacc_p.float(), atol=1e-2,
                               rtol=1e-2)
    assert _rel(dq, dq_p) < 1e-2
    assert _rel(db, db_p) < 1e-2


@pytest.mark.parametrize("d,f,e", [(24, 13, 5), (600, 129, 50), (37, 10, 20),
                                   (64, 3, 256), (130, 7, 16)])
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_k3_pack_matches_its_mirror(dev, d, f, e, w_dtype):
    """The pack kernel writes W's swizzled tiles exactly as
    `pack_w_mirror` lays them out (bit-equal: both round the same values
    to bf16), zero past D and past each tile's columns."""
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    w = _maskhead_args(dev, 1, 1, d, f, e, 1, w_dtype)[1]
    got = m.pack_w(w, f, e)
    assert torch.equal(got, m.pack_w_mirror(w, f, e))


@pytest.mark.parametrize("b,t,d,f,e,k", MASKHEAD_SHAPES)
@pytest.mark.parametrize("w_dtype", [torch.float32, torch.bfloat16])
def test_k3_k6_match_the_tile_mirrors(dev, b, t, d, f, e, k, w_dtype):
    """K3 and K6 against the plain-torch mirrors of their order of work on
    the same packed W. Masks: the E-sum of bf16 terms in f32 in another
    order, and where the recomputed g differs by summation order one
    flipped bf16 rounding of a g*q term (2^-8 of a term below 4, times the
    sigmoid's slope 0.25 at most: 7.5e-3 max abs); dacc, dq and db: one
    flipped bf16 rounding where the recomputed g differs by summation
    order (1e-2 relative L2, K6's bar)."""
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    h, w, bias, q = _maskhead_args(dev, b, t, d, f, e, k, w_dtype, seed=11)
    wt = m.pack_w(w, f, e)
    masks = m.fused_dot_masks_cuda(h, w, bias, q, f, e, torch.float32)
    torch.testing.assert_close(
        masks, m.fused_dot_masks_tile_mirror(h, wt, bias, q, f, e,
                                             torch.float32),
        atol=7.5e-3, rtol=0)
    m16 = masks.to(torch.bfloat16)
    dout = _t(np.random.default_rng(12).standard_normal((b, k, t, f)), dev,
              torch.bfloat16)
    got = m.fused_dot_masks_bwd_cuda(h, w, bias, q, m16, dout, f, e)
    ref = m.fused_dot_masks_bwd_tile_mirror(h, wt, bias, q, m16, dout, f, e)
    for name, a, r in zip(("dacc", "dq", "db"), got, ref):
        assert _rel(a, r) < 1e-2, name


@pytest.mark.parametrize("b,t,d,f,e,k", [(1, 313, 600, 129, 50, 2),
                                         (16, 313, 600, 129, 50, 2),
                                         (2, 33, 37, 10, 20, 2),
                                         (3, 313, 64, 3, 256, 3)])
def test_k3_k6_two_calls_are_bit_equal(dev, b, t, d, f, e, k):
    """No atomics: the partials of dq and db are summed in a fixed order,
    so two calls give the same bits."""
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    h, w, bias, q = _maskhead_args(dev, b, t, d, f, e, k)
    masks = [m.fused_dot_masks_cuda(h, w, bias, q, f, e, torch.bfloat16)
             for _ in range(2)]
    assert torch.equal(masks[0], masks[1])
    dout = _t(np.random.default_rng(13).standard_normal((b, k, t, f)), dev,
              torch.bfloat16)
    one, two = (m.fused_dot_masks_bwd_cuda(h, w, bias, q, masks[0], dout, f,
                                           e) for _ in range(2))
    for a, c in zip(one, two):
        assert torch.equal(a, c)


@pytest.mark.parametrize("b,t,d,f,e,k", [(16, 313, 600, 129, 50, 2),
                                         (3, 100, 600, 129, 50, 3),
                                         (2, 33, 37, 10, 20, 2)])
def test_k6_db_and_the_bf16_products(dev, b, t, d, f, e, k):
    """db from K6's partials against the f32 sum of its own dacc (f32
    summation order only: 1e-5 relative L2); dW and dh as bf16-operand
    products with f32 output (`dacc_products`, cuBLAS) against the f32
    products of the upcast operands (`dacc_products_plain`): a product of
    two bf16 values is exact in f32, so they differ by summation order
    only, within 1e-3 relative L2."""
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    h, w, bias, q = _maskhead_args(dev, b, t, d, f, e, k, torch.float32)
    masks = m.fused_dot_masks_cuda(h, w, bias, q, f, e, torch.bfloat16)
    dout = _t(np.random.default_rng(14).standard_normal((b, k, t, f)), dev,
              torch.bfloat16)
    dacc, _, db = m.fused_dot_masks_bwd_cuda(h, w, bias, q, masks, dout, f, e)
    assert _rel(db, dacc.float().sum((0, 1))) < 1e-5
    got, ref = m.dacc_products(h, w, dacc), m.dacc_products_plain(h, w, dacc)
    for name, a, r in zip(("dh", "dW"), got, ref):
        assert a.dtype == torch.float32 and a.shape == r.shape, name
        assert _rel(a, r) < 1e-3, name


def test_k3_k6_refuse_more_than_four_queries(dev):
    from dl4ss_tpu_torch.ops import maskhead_kernels as m
    h, w, bias, q = _maskhead_args(dev, 1, 9, 16, 3, 4, 5)
    with pytest.raises(ValueError, match="queries"):
        m.fused_dot_masks_cuda(h, w, bias, q, 3, 4, torch.float32)


def test_backward_launches_k5_k6_and_matches_the_plain_route(dev):
    """A loss through the separator on the kernel route launches K5 and K6
    in its backward, reaches every encoder, projection and embedding
    parameter, and agrees with the same model on the plain route (kernel
    flags off) within the bf16 mask head's 5e-2 relative L2."""
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.models import init_separator, separate
    from dl4ss_tpu_torch.ops import cuda_lib
    cfg = preset("synth_tiny").replace(use_pallas_rnn=True,
                                       use_pallas_maskhead=True)
    model = init_separator(cfg, torch.Generator().manual_seed(0), dev)
    feat = _t(np.abs(np.random.default_rng(8).standard_normal(
        (2, 31, cfg.freq_bins))), dev)
    spk = torch.tensor([[0, 1], [2, 3]], device=dev)
    grads = []
    for c in (cfg, cfg.replace(use_pallas_rnn=False,
                               use_pallas_maskhead=False)):
        model.zero_grad()
        before = dict(cuda_lib.LAUNCHES)
        separate(model, feat, c, spk_idx=spk).pred.square().mean().backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        if c is cfg:
            for name in ("gru_bwd", "maskhead_bwd"):
                assert cuda_lib.LAUNCHES[name] > before.get(name, 0), name
    assert set(grads[0]) == set(grads[1])
    for name, g in grads[0].items():
        assert _rel(g, grads[1][name]) < 5e-2, name


def test_k1_refuses_an_input_that_requires_grad(dev):
    """K1 has no backward (nor has the JAX kernel): on the card it raises
    rather than return features cut off from the graph."""
    from dl4ss_tpu_torch.ops.stft_kernels import stft_features
    x = torch.zeros((1, 1000), device=dev, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        stft_features(x)
    with torch.no_grad():
        assert stft_features(x)[0].shape == (1, 8, 129)


@pytest.mark.parametrize("t,b,h", [(7, 1, 33), (7, 5, 300), (7, 5, 600),
                                   (3, 17, 8)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 2e-2)])
def test_k7_lstm_fwd(dev, t, b, h, dtype, tol):
    """K7 against its plain version, hs and cs, at ragged shapes and at
    the classifier widths 300 and 600."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(9)
    s = 1 / np.sqrt(h)
    xp = _t(rng.standard_normal((t, 2, b, 4 * h)), dev, dtype)
    wh = _t(rng.uniform(-s, s, (2, h, 4 * h)), dev, dtype)
    for name, g, r in zip(("hs", "cs"), k.lstm_scan_cuda(xp, wh),
                          k.lstm_scan_plain(xp, wh)):
        assert g.shape == r.shape and g.dtype == r.dtype == dtype, name
        torch.testing.assert_close(g.float(), r.float(), atol=tol, rtol=0,
                                   msg=name)


# (7, 5, 600): past the width the resident body holds in registers; T=313
# at B=16, 32 and 128 (one, two and seven resident launches) and at H=600
# (the TDAA classifier's step)
@pytest.mark.parametrize("t,b,h", [(7, 1, 33), (7, 5, 300), (7, 5, 600),
                                   (12, 3, 45), (4, 17, 300), (313, 16, 300),
                                   (313, 32, 300), (313, 128, 300),
                                   (313, 16, 600)])
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 5e-2)])
@pytest.mark.parametrize("body", ["resident", "stepwise"])
def test_k8_lstm_bwd(dev, t, b, h, dtype, tol, body):
    """K8, both bodies, against its plain version on the forward's own hs
    and cs. f32: only the summation order and the order of the coefficient
    products differ (1e-4). bf16: da is rounded to bf16 before both
    products, so an order difference can flip one rounding and carry it
    back through the steps (5e-2, the repo's gradient bar for bf16
    kernels)."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    rng = np.random.default_rng(10)
    s = 1 / np.sqrt(h)
    xp = _t(rng.standard_normal((t, 2, b, 4 * h)), dev, dtype)
    wh = _t(rng.uniform(-s, s, (2, h, 4 * h)), dev, dtype)
    hs, cs = k.lstm_scan_cuda(xp, wh)
    zeros = torch.zeros_like(hs[:1])
    args = (xp, wh, torch.cat([zeros, hs[:-1]]), torch.cat([zeros, cs[:-1]]),
            cs, _t(rng.standard_normal((t, 2, b, h)), dev, dtype))
    _check_bodies(k, "lstm_bwd", k.lstm_scan_bwd_cuda,
                  k.lstm_scan_bwd_plain, args, h, tol, body, ("dxp", "dU"))


@pytest.mark.parametrize("b,n,length,hop,body", [
    (1, 3001, 256, 128, "fft"), (5, 777, 64, 16, "fft"),
    (2, 1000, 256, 64, "fft"), (3, 333, 32, 8, "fft"),
    (1, 5003, 512, 128, "fft"), (2, 9001, 2048, 512, "fft"),
    (2, 1001, 96, 48, "direct"), (16, 40000, 256, 128, "fft"),
    (16, 40000, 96, 48, "direct")])
@pytest.mark.parametrize("center", [True, False])
def test_k9_stft_ri(dev, b, n, length, hop, body, center):
    """K9 against its plain version (N not a multiple of hop), centered
    and not, through the body its frame length names, and its packed
    halves against K1's Re and Im."""
    from dl4ss_tpu_torch.ops import stft_kernels as k
    from dl4ss_tpu_torch.ops.stft import reflect_pad
    x = _t(np.random.default_rng(11).uniform(-1, 1, (b, n)), dev)
    xin = (reflect_pad(x, length // 2) if center else x).contiguous()
    before = _ran(k, "stft_ri", body)
    got = k.stft_ri_cuda(xin, length, hop, "hann")
    assert _ran(k, "stft_ri", body) == before + 1
    ref = k.stft_ri_plain(xin, length, hop, "hann")
    assert got.shape == ref.shape
    torch.testing.assert_close(got, ref, atol=1e-4, rtol=0)
    torch.testing.assert_close(k.stft_ri(x, length, hop, "hann", center), got)
    _, re, im = k.stft_features_cuda(xin, length, hop, "hann", torch.float32)
    torch.testing.assert_close(got, torch.cat([re, im], dim=-1), atol=1e-6,
                               rtol=0)


@pytest.mark.parametrize("b,t,length,hop", [(1, 9, 256, 128),
                                            (5, 13, 64, 16),
                                            (9, 6, 256, 64),
                                            (1, 1, 256, 128),
                                            (2, 8, 32, 32),
                                            (3, 17, 512, 128),
                                            (16, 313, 256, 128)])
@pytest.mark.parametrize("body", ["fft", "direct"])
def test_k10_istft_ri(dev, b, t, length, hop, body):
    """K10 on the body named against its plain version, the raw
    overlap-add (the FFT body also against its mirror, 1e-5, and a second
    call, bit-equal), and the whole `istft_ri` with its three length cases
    on the rule's body."""
    from dl4ss_tpu_torch.ops import stft_kernels as k
    f = length // 2 + 1
    ri = _t(np.random.default_rng(12).standard_normal((b, t, 2 * f)), dev)
    before = _ran(k, "istft_ri", body)
    got = k.istft_ola_cuda(ri, length, hop, "hann", body=body)
    assert _ran(k, "istft_ri", body) == before + 1
    torch.testing.assert_close(got, k.istft_ola_plain(ri, length, hop,
                                                      "hann"),
                               atol=1e-4, rtol=0)
    if body == "fft":
        torch.testing.assert_close(
            got, k.istft_fft_mirror(ri[..., :f], ri[..., f:], length, hop,
                                    "hann"), atol=1e-5, rtol=0)
        assert torch.equal(got, k.istft_ola_cuda(ri, length, hop, "hann",
                                                 body=body))
    default = (t - 1) * hop
    for want in (None, default + 50, default // 2):
        got = k.istft_ri(ri, length, hop, length=want)
        ref = k.istft_ri(ri.cpu(), length, hop, length=want)
        assert got.shape == ref.shape == (b, want or default)
        if hop < length:        # at hop = L see test_k4_masked_istft
            torch.testing.assert_close(got.cpu(), ref, atol=1e-4, rtol=0)


def test_k9_k10_round_trip_and_refusals(dev):
    from dl4ss_tpu_torch.ops import stft_kernels as k
    x = _t(np.random.default_rng(13).uniform(-1, 1, (3, 5000)), dev)
    y = k.istft_kernel(k.stft_kernel(x), length=5000)
    torch.testing.assert_close(y[:, :4864], x[:, :4864], atol=1e-4, rtol=0)
    with pytest.raises(ValueError, match="frame_length % frame_shift"):
        k.stft_ri(x, 256, 96)
    with pytest.raises(RuntimeError, match="no backward"):
        k.stft_ri(x.clone().requires_grad_())


def test_classifier_backward_launches_k8_and_matches_the_plain_route(dev):
    """A loss on the classifier's logits on the kernel route launches K7
    in the forward and K8 in the backward (once per layer), reaches every
    classifier parameter, and agrees with the plain route (f32 both: 1e-3
    relative L2, summation order through two layers and 31 steps)."""
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.models import classify_speakers, init_separator
    from dl4ss_tpu_torch.ops import cuda_lib
    cfg = preset("synth_tiny").replace(use_pallas_rnn=True)
    model = init_separator(cfg, torch.Generator().manual_seed(0), dev)
    feat = _t(np.abs(np.random.default_rng(14).standard_normal(
        (5, 31, cfg.freq_bins))), dev)
    grads = []
    for c in (cfg, cfg.replace(use_pallas_rnn=False)):
        model.zero_grad()
        before = dict(cuda_lib.LAUNCHES)
        classify_speakers(model, feat, c, logits=True).square().mean(
            ).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()
                      if p.grad is not None})
        if c is cfg:
            for name in ("lstm_fwd", "lstm_bwd"):
                assert cuda_lib.LAUNCHES[name] - before.get(name, 0) \
                    == cfg.classifier_layers, name
    assert set(grads[0]) == set(grads[1]) == {
        n for n, _ in model.named_parameters() if n.startswith("classifier.")}
    for name, g in grads[0].items():
        assert _rel(g, grads[1][name]) < 1e-3, name


def test_selected_and_recursive_serving_launch_k7(dev):
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.models import init_separator
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.serve import (recursive_waveforms,
                                       select_and_separate,
                                       separate_waveforms)
    cfg = preset("synth_tiny").replace(use_pallas_rnn=True,
                                       use_pallas_stft=True,
                                       use_pallas_maskhead=True)
    model = init_separator(cfg, torch.Generator().manual_seed(0), dev)
    wav = _t(np.random.default_rng(15).uniform(-1, 1, (2, cfg.max_len)), dev)
    cuda_lib.LAUNCHES.clear()
    wavs, spk = select_and_separate(model, wav, cfg, length=cfg.max_len)
    assert {n: cuda_lib.LAUNCHES[n] for n in cuda_lib.SELECTION_KERNELS} == {
        "stft_features": 1, "gru_fwd": cfg.encoder_layers,
        "lstm_fwd": cfg.classifier_layers, "maskhead_fwd": 1,
        "masked_istft": 1}
    torch.testing.assert_close(
        wavs, separate_waveforms(model, wav, cfg, spk, length=cfg.max_len))
    cuda_lib.LAUNCHES.clear()
    rec, steps = recursive_waveforms(model, wav, cfg, length=cfg.max_len)
    assert rec.shape == (2, cfg.recursive_max_steps, cfg.max_len)
    assert cuda_lib.LAUNCHES["lstm_fwd"] \
        == cfg.classifier_layers * cfg.recursive_max_steps
    assert cuda_lib.LAUNCHES["gru_fwd"] \
        == cfg.encoder_layers * cfg.recursive_max_steps
    assert bool(torch.isfinite(rec).all())


def test_k7_k8_stepwise_at_the_tdaa_classifier_width(dev):
    """The tdaa classifier's BiLSTM at 2H = 600, past the resident body's
    width: K7 runs the wide body and K8 the stepwise one, and both match
    their plain versions (forward max abs, backward relative L2, f32)."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    t, b, h = 40, 16, 600
    rng = np.random.default_rng(60)
    sc = 1.0 / np.sqrt(h)
    xp = _t(0.5 * rng.standard_normal((t, 2, b, 4 * h)), dev)
    wh = _t(rng.uniform(-sc, sc, (2, h, 4 * h)), dev)
    dhs = _t(rng.standard_normal((t, 2, b, h)), dev)
    assert k.rnn_body(h, b) == "wide"
    assert k.rnn_body(h, b, backward=True) == "stepwise"
    before = dict(k.BODY_LAUNCHES)
    hs, cs = k.lstm_scan_cuda(xp, wh)
    ref_hs, ref_cs = k.lstm_scan_plain(xp, wh)
    assert float((hs - ref_hs).abs().max()) < 1e-4
    assert float((cs - ref_cs).abs().max()) < 1e-4
    zeros = torch.zeros_like(hs[:1])
    args = (xp, wh, torch.cat([zeros, hs[:-1]]), torch.cat([zeros, cs[:-1]]),
            cs, dhs)
    got = k.lstm_scan_bwd_cuda(*args)
    ref = k.lstm_scan_bwd_plain(*args)
    for g, r in zip(got, ref):
        assert float((g - r).norm() / r.norm()) < 1e-4
    for name, body in (("lstm_fwd", "wide"), ("lstm_bwd", "stepwise")):
        assert (k.BODY_LAUNCHES[name, body]
                == before.get((name, body), 0) + 1)


def test_k7_wide_body_at_its_edges(dev):
    """The wide body at the edges of the rule on this card: the widest H
    whose D * ceil(H / 10) blocks fit its SMs, both directions at the rule's
    most rows there (48 at H=660 on 132 SMs, where a block's shared memory
    ends too), and one direction at B=1 at the widest H that fits a block
    (1248), each named by the rule and matching the plain version (f32,
    1e-4); one width and one row past what the library holds are refused,
    no launch counted."""
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import rnn_kernels as k
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    widest = k.WIDE_UNITS * (sms // 2)
    rows = max(b for b in range(1, 200)
               if k.wide_smem_bytes(widest, b) <= k.SMEM_PER_BLOCK)
    lone = max(h for h in range(305, 2000)
               if k.wide_smem_bytes(h, 1) <= k.SMEM_PER_BLOCK
               and -(-h // k.WIDE_UNITS) <= sms)
    rng = np.random.default_rng(61)

    def args(t, d, b, h):
        sc = 1.0 / np.sqrt(h)
        return (_t(0.5 * rng.standard_normal((t, d, b, 4 * h)), dev),
                _t(rng.uniform(-sc, sc, (d, h, 4 * h)), dev))

    for t, d, b, h in ((2, 2, min(rows, k.WIDE_MAX_BATCH), widest),
                       (2, 1, 1, lone)):
        assert k.rnn_body(h, b, d, sms=sms) == "wide"
        xp, wh = args(t, d, b, h)
        for g, r in zip(k.lstm_scan_cuda(xp, wh), k.lstm_scan_plain(xp, wh)):
            torch.testing.assert_close(g, r, atol=1e-4, rtol=0)
    for t, d, b, h in ((2, 2, 1, widest + 1), (2, 2, rows + 1, widest),
                       (2, 1, 1, lone + 1)):
        assert k.rnn_body(h, b, d, sms=sms) == "stepwise"
        xp, wh = args(t, d, b, h)
        before = dict(k.BODY_LAUNCHES), dict(cuda_lib.LAUNCHES)
        with pytest.raises(RuntimeError, match="lstm_fwd failed"):
            k.lstm_scan_cuda(xp, wh, body="wide")
        torch.cuda.synchronize()
        assert (dict(k.BODY_LAUNCHES), dict(cuda_lib.LAUNCHES)) == before


def _tdaa_small(**over):
    from dl4ss_tpu_torch import preset
    return preset("tdaa").replace(hidden_units=48, embedding_size=10,
                                  num_speakers=12, max_len_seconds=0.5,
                                  batch_size=3, **over)


def test_k3_masks_bit_equal_across_save_and_restore(dev, tmp_path):
    """K3 packs W once per version of the tensor: a restore writes the
    saved W back in place, so the next call repacks and gives the masks of
    before, bit for bit."""
    from dl4ss_tpu_torch.models import separate
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.train.checkpoint import (restore_checkpoint,
                                                  save_checkpoint)
    from dl4ss_tpu_torch.train.state import create_train_state
    cfg = _tdaa_small()
    state = create_train_state(cfg, seed=2, device=dev)
    feat = _t(np.abs(np.random.default_rng(1).standard_normal(
        (3, 21, cfg.freq_bins))), dev)
    spk = torch.tensor([[0, 1], [2, 3], [4, 5]], device=dev)

    def masks():
        with torch.no_grad():
            return separate(state.model, feat, cfg, spk_idx=spk).masks
    saved = masks()
    save_checkpoint(str(tmp_path), state)
    with torch.no_grad():
        state.model.encoder.proj.w.mul_(1.5)
    moved = masks()
    packs = cuda_lib.LAUNCHES["maskhead_pack"]
    restore_checkpoint(str(tmp_path), state)
    restored = masks()
    assert cuda_lib.LAUNCHES["maskhead_pack"] == packs + 1
    assert not torch.equal(saved, moved)
    assert torch.equal(saved, restored)


def _leaves(model):
    return {n: p.detach().float().cpu().clone()
            for n, p in model.named_parameters()}


def test_tdaa_dense_step_kernel_route_matches_plain(dev):
    """One dense step of a small tdaa model on the card (K1, K7, K8)
    against the same step on a CPU copy (their plain versions): 2e-2 on
    the loss, 5e-2 relative L2 on each update."""
    import copy

    from dl4ss_tpu_torch.data.synth import (featurize, make_synthetic_bank,
                                            sample_mixtures)
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.train.state import create_train_state
    from dl4ss_tpu_torch.train.steps import make_dense_train_step
    cfg = _tdaa_small()
    state = create_train_state(cfg, seed=3, device=dev)
    twin = copy.deepcopy(state.model).to("cpu")
    bank = torch.as_tensor(make_synthetic_bank(0, cfg.num_speakers, 2,
                                               cfg.max_len), device=dev)
    feats = featurize(sample_mixtures(torch.Generator().manual_seed(0),
                                      bank, cfg), cfg)
    before = _leaves(state.model)
    step = make_dense_train_step(cfg)
    launches = dict(cuda_lib.LAUNCHES)
    _, met_g = step(state, feats)
    assert (cuda_lib.LAUNCHES["lstm_bwd"] - launches.get("lstm_bwd", 0)
            == cfg.encoder_layers)
    _, met_c = step(create_train_state(cfg, model=twin, device="cpu"),
                    {k: v.cpu() for k, v in feats.items()})
    got, ref = float(met_g["loss"]), float(met_c["loss"])
    assert abs(got - ref) <= 2e-2 * abs(ref)
    after_g, after_c = _leaves(state.model), _leaves(twin)
    for name, b in before.items():
        want, upd = after_c[name] - b, after_g[name] - b
        if not bool(want.any()):
            assert not bool(upd.any()), name
            continue
        assert float((upd - want).norm() / want.norm()) < 5e-2, name


def test_remat_gradients_are_bit_equal_on_the_kernel_route(dev):
    """remat recomputes each recurrent layer (K7 again) in the backward:
    the gradients equal remat=False's bit for bit."""
    from dl4ss_tpu_torch.models import init_separator, separate
    from dl4ss_tpu_torch.ops import cuda_lib
    cfg = _tdaa_small(use_discriminator=False)
    model = init_separator(cfg, torch.Generator().manual_seed(4), dev)
    feat = _t(np.abs(np.random.default_rng(2).standard_normal(
        (3, 21, cfg.freq_bins))), dev)
    spk = torch.tensor([[0, 1], [2, 3], [4, 5]], device=dev)
    grads, fwd = [], []
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        before = cuda_lib.LAUNCHES["lstm_fwd"]
        out = separate(model, feat, c, spk_idx=spk, need_probs=True)
        loss = out.pred.float().square().mean() + out.probs.square().mean()
        grads.append(torch.autograd.grad(loss, list(model.parameters()),
                                         allow_unused=True))
        fwd.append(cuda_lib.LAUNCHES["lstm_fwd"] - before)
    layers = cfg.encoder_layers + cfg.classifier_layers
    assert fwd == [layers, 2 * layers]
    for a, b in zip(*grads):
        assert (a is None and b is None) or torch.equal(a, b)
