"""The DSP kernels: K1 (STFT features), K4 (masked iSTFT), K9 (packed STFT)
and K10 (iSTFT of a packed spectrum). CUDA kernels and plain versions.

Ports `pallas_stft_features`, `pallas_masked_istft`, `pallas_stft_ri` /
`pallas_stft` and `pallas_istft_ri` / `pallas_istft`
(dl4ss_tpu/ops/pallas_stft.py). Each public wrapper sends a CPU tensor to
the plain PyTorch version and a CUDA tensor to the hand-written kernel
(csrc/stft_features.cu, csrc/masked_istft.cu, csrc/stft_ri.cu,
csrc/istft_ri.cu); there is no fallback from one to the other. The
`*_plain` and `*_cuda` halves are public so that a check can hold one
against the other on the same inputs. None of the four has a backward (nor
have the JAX kernels): on the card an input that requires grad raises
rather than giving a detached result.

K1 and K9 share one CUDA tile (csrc/stft_tile.cuh) with two hand-written
bodies: a shared-memory real FFT for a power-of-two frame length, the
direct product for any other (`stft_body` is the rule). K4 and K10 share
the inverse tile (csrc/istft_tile.cuh) the same way: a shared-memory
inverse real FFT with the overlap-add in the block, or the direct iDFT
(`istft_body` is the rule). Both FFTs run the stages of csrc/fft_stages.cuh.
The FFT bodies cannot run off the card, so `stft_fft_mirror` and
`istft_fft_mirror` repeat their steps one for one in plain torch for the
CPU tests; nothing on a serving or training path calls the mirrors.
"""

from __future__ import annotations

import collections
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from dl4ss_tpu_torch.ops import cuda_lib
from dl4ss_tpu_torch.ops.stft import (_trim, dft_matrix, dsp_tables,
                                      idft_matrix, overlap_add, reflect_pad,
                                      table_cache)
from dl4ss_tpu_torch.ops.windows import get_window

_FEAT_DTYPES = (torch.float32, torch.bfloat16)


def _bins(frame_length: int) -> int:
    return frame_length // 2 + 1


def _check_input(x: torch.Tensor, fn: str, kernel: str, dims: int) -> None:
    """A `dims`-axis float32 tensor that, on the card, needs no gradient."""
    if x.is_cuda and x.requires_grad and torch.is_grad_enabled():
        raise RuntimeError(f"{fn}: {kernel} has no backward; pass an input "
                           f"that does not require grad")
    if x.dim() != dims or x.dtype != torch.float32:
        raise ValueError(f"{fn} wants {dims} axes of float32, got "
                         f"{tuple(x.shape)} {x.dtype}")


def _check_hop(fn: str, frame_length: int, frame_shift: int) -> None:
    if frame_length % frame_shift:
        raise ValueError(f"{fn} needs frame_length % frame_shift == 0, got "
                         f"{frame_length} and {frame_shift}")


# ---------------------------------------------------------------------------
# K1: STFT features
# ---------------------------------------------------------------------------


def stft_features(x: torch.Tensor, frame_length: int = 256,
                  frame_shift: int = 128, window: str = "hann",
                  center: bool = True, feat_dtype=torch.float32
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, N) f32 -> (mag (B, T, F) in feat_dtype, re, im (B, T, F) f32).

    One pass emits the magnitude feature and the spectrum halves that
    `masked_istft` resynthesises from, so the serving path never forms a
    phasor. The reflect pad is a torch op before the kernel, as in JAX.
    The kernel has no backward (nor has the JAX one): on the card an input
    that requires grad raises rather than giving a detached result.
    """
    _check_input(x, "stft_features", "the STFT feature kernel (K1)", 2)
    if center:
        x = reflect_pad(x, frame_length // 2)
    x = x.contiguous()
    if x.is_cuda:
        return stft_features_cuda(x, frame_length, frame_shift, window,
                                  feat_dtype)
    return stft_features_plain(x, frame_length, frame_shift, window,
                               feat_dtype)


def spectral_feature_kernel(wav: torch.Tensor, frame_length: int = 256,
                            frame_shift: int = 128, window: str = "hann"
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, N) f32 -> (|STFT| (B, T, F), packed spectrum (B, T, F, 2) with
    Re and Im on the last axis): `stft_features` (K1 on the card) with the
    halves stacked, JAX's `pallas_spectral_feature`."""
    mag, re, im = stft_features(wav, frame_length, frame_shift, window)
    return mag, torch.stack([re, im], dim=-1)


def stft_features_plain(xpad: torch.Tensor, frame_length: int,
                        frame_shift: int, window: str, feat_dtype):
    """K1's plain version on the padded signal (B, Np)."""
    tab = dsp_tables(frame_length, window, xpad.device)
    bins = _bins(frame_length)
    frames = xpad.unfold(-1, frame_length, frame_shift) * tab.win
    # one product against the whole table, split after it: K9's plain
    # version runs the same product, so the two agree bit for bit on any
    # CPU (two half-width products sum in another order)
    ri = torch.matmul(frames, tab.dft)
    re, im = ri[..., :bins].contiguous(), ri[..., bins:].contiguous()
    return torch.sqrt(re * re + im * im).to(feat_dtype), re, im


@table_cache
def _dft_halves(frame_length: int, device: torch.device):
    """cos and -sin tables, each (L, F) contiguous: the direct body's."""
    dft = torch.as_tensor(dft_matrix(frame_length), device=device)
    bins = _bins(frame_length)
    return dft[:, :bins].contiguous(), dft[:, bins:].contiguous()


# The two bodies of the STFT and iSTFT tiles and the frame lengths their
# FFT bodies take; the iSTFT's also takes at most ISTFT_FFT_MAX_RATIO
# frames over a sample (csrc/istft_tile.cuh).
BODY_FFT, BODY_DIRECT = "fft", "direct"
_BODY_CODES = {BODY_FFT: 1, BODY_DIRECT: 2}
FFT_MIN_LENGTH, FFT_MAX_LENGTH = 32, 2048
ISTFT_FFT_MAX_RATIO = 8
# Launches of K1, K4, K9 and K10 by the body that ran, keyed (kernel name,
# body); cuda_lib.LAUNCHES counts both bodies under the kernel's name.
BODY_LAUNCHES: collections.Counter = collections.Counter()
cuda_lib.COUNTERS.append(BODY_LAUNCHES)


def _fft_length(frame_length: int) -> bool:
    pow2 = frame_length > 0 and frame_length & (frame_length - 1) == 0
    return pow2 and FFT_MIN_LENGTH <= frame_length <= FFT_MAX_LENGTH


def stft_body(frame_length: int, frame_shift: int) -> str:
    """The shape rule of K1 and K9 on the card: the FFT body for a
    power-of-two frame length in [32, 2048] with hop <= L, the direct body
    for every other shape. The launch is told the body by name; the library
    only refuses the FFT body on a shape it cannot take."""
    if _fft_length(frame_length) and frame_shift <= frame_length:
        return BODY_FFT
    return BODY_DIRECT


def istft_body(frame_length: int, frame_shift: int) -> str:
    """The shape rule of K4 and K10 on the card: the FFT body for a
    power-of-two frame length in [32, 2048] whose hop divides it at most
    ISTFT_FFT_MAX_RATIO times (every preset: 256 / 128), the direct body
    for every other shape. As for `stft_body`, the launch is told the body
    by name and the library only refuses the FFT body where it cannot
    run."""
    if (_fft_length(frame_length) and frame_shift > 0
            and frame_length % frame_shift == 0
            and frame_length // frame_shift <= ISTFT_FFT_MAX_RATIO):
        return BODY_FFT
    return BODY_DIRECT


@functools.lru_cache(maxsize=None)
def twiddle_table(frame_length: int) -> np.ndarray:
    """(L/2+1, 2) f32: cos and -sin of 2 pi k / L, computed in float64.
    The FFT body's only trigonometric table: W_L^k for k <= L/2; the
    stages of the half-length FFT read W_{L/2}^k = W_L^{2k} from it."""
    ang = 2.0 * np.pi * np.arange(frame_length // 2 + 1) / frame_length
    return np.stack([np.cos(ang), -np.sin(ang)], axis=1).astype(np.float32)


@table_cache
def _twiddles(frame_length: int, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(twiddle_table(frame_length), device=device)


def _launch_stft(name: str, xpad: torch.Tensor, outs, sizes, frame_length: int,
                 frame_shift: int, window: str, tail, body: Optional[str]
                 ) -> None:
    """Launch K1 or K9 with the tables of the body that runs: `stft_body`'s
    for the shape, unless `body` names one, for a check or a timing of one
    against the other."""
    dev = xpad.device
    chosen = body or stft_body(frame_length, frame_shift)
    win = dsp_tables(frame_length, window, dev).win
    tw, cos_t, sin_t = 0, 0, 0
    if chosen == BODY_FFT:
        tw = _twiddles(frame_length, dev)
    else:
        cos_t, sin_t = _dft_halves(frame_length, dev)
    cuda_lib.launch(name, dev, xpad, win, tw, cos_t, sin_t, *outs, *sizes,
                    frame_length, frame_shift, _bins(frame_length), *tail,
                    _BODY_CODES[chosen])
    BODY_LAUNCHES[name, chosen] += 1


def stft_features_cuda(xpad: torch.Tensor, frame_length: int,
                       frame_shift: int, window: str, feat_dtype,
                       body: Optional[str] = None):
    """K1 on the card: csrc/stft_features.cu on the padded signal (B, Np).
    `body` forces one of the tile's two bodies; by default the shape
    decides."""
    cuda_lib.check(xpad, "x", (torch.float32,))
    if feat_dtype not in _FEAT_DTYPES:
        raise TypeError(f"feat_dtype must be one of {_FEAT_DTYPES}")
    b, n_pad = xpad.shape
    t = 1 + (n_pad - frame_length) // frame_shift
    f = _bins(frame_length)
    mag = torch.empty((b, t, f), dtype=feat_dtype, device=xpad.device)
    re = torch.empty((b, t, f), dtype=torch.float32, device=xpad.device)
    im = torch.empty_like(re)
    _launch_stft("stft_features", xpad, (mag, re, im), (b, n_pad, t),
                 frame_length, frame_shift, window,
                 (int(feat_dtype == torch.bfloat16),), body)
    return mag, re, im


def _cmul(ar, ai, wr, wi):
    return ar * wr - ai * wi, ar * wi + ai * wr


def _fft_stages_mirror(zr: torch.Tensor, zi: torch.Tensor, frame_length: int,
                       table: torch.Tensor):
    """csrc/fft_stages.cuh's `fft_forward` in plain torch: the N = L/2
    point forward FFT of z (last axis) as Stockham stages, radix 4 and then
    one radix-2 stage when log2 N is odd, with the twiddles of the (L/2+1,
    2) table (the upper half by W^q = -W^(q-L/2))."""
    dev = zr.device
    half = n = frame_length // 2

    def twiddle(q):
        """W_L^q for 0 <= q < L as (re, im) from the half table."""
        upper = q > half
        w = table[torch.where(upper, q - half, q)]
        sign = torch.where(upper, -1.0, 1.0).to(w.dtype)
        return w[:, 0] * sign, w[:, 1] * sign

    p = 1
    while 4 * p <= n:                           # radix-4 stages
        quarter, step = n // 4, frame_length // (4 * p)
        i = torch.arange(quarter, device=dev)
        k = i & (p - 1)
        u = [(zr[..., i + m * quarter], zi[..., i + m * quarter])
             for m in range(4)]
        if p > 1:
            u[1:] = [_cmul(*u[m], *twiddle(m * k * step)) for m in (1, 2, 3)]
        (u0r, u0i), (u1r, u1i), (u2r, u2i), (u3r, u3i) = u
        v0r, v0i, v1r, v1i = u0r + u2r, u0i + u2i, u0r - u2r, u0i - u2i
        v2r, v2i = u1r + u3r, u1i + u3i
        v3r, v3i = u1i - u3i, -(u1r - u3r)      # -i (u1 - u3)
        j = ((i - k) << 2) + k
        yr, yi = torch.empty_like(zr), torch.empty_like(zi)
        for m, (vr, vi) in enumerate(((v0r + v2r, v0i + v2i),
                                      (v1r + v3r, v1i + v3i),
                                      (v0r - v2r, v0i - v2i),
                                      (v1r - v3r, v1i - v3i))):
            yr[..., j + m * p], yi[..., j + m * p] = vr, vi
        zr, zi, p = yr, yi, 4 * p
    if p < n:                                   # the last radix-2 stage
        k = torch.arange(n // 2, device=dev)
        u1r, u1i = _cmul(zr[..., n // 2:], zi[..., n // 2:],
                         *twiddle(k * (frame_length // n)))
        u0r, u0i = zr[..., :n // 2], zi[..., :n // 2]
        zr = torch.cat([u0r + u1r, u0r - u1r], dim=-1)
        zi = torch.cat([u0i + u1i, u0i - u1i], dim=-1)
    return zr, zi


def stft_fft_mirror(xpad: torch.Tensor, frame_length: int, frame_shift: int,
                    window: str) -> torch.Tensor:
    """The FFT body of csrc/stft_tile.cuh step for step in plain torch, on
    the (padded) signal (B, Np): packed (B, T, 2F) like `stft_ri_plain`.

    Same even/odd packing z[n] = w[2n] x[2n] + i w[2n+1] x[2n+1], same
    twiddle table, same Stockham stages (`_fft_stages_mirror`) and the
    same split into the L/2+1 bins. It uses no `torch.fft`. For the CPU
    tests and the card check of the kernel; no serving or training path
    calls it.
    """
    if stft_body(frame_length, frame_shift) != BODY_FFT:
        raise ValueError(f"the FFT body takes a power-of-two frame length in "
                         f"[{FFT_MIN_LENGTH}, {FFT_MAX_LENGTH}] and hop <= L, "
                         f"got {frame_length} and {frame_shift}")
    dev = xpad.device
    n = frame_length // 2                       # points of the complex FFT
    win = dsp_tables(frame_length, window, dev).win
    table = _twiddles(frame_length, dev)
    frames = xpad.unfold(-1, frame_length, frame_shift) * win
    zr, zi = _fft_stages_mirror(frames[..., 0::2].contiguous(),
                                frames[..., 1::2].contiguous(), frame_length,
                                table)
    k = torch.arange(n + 1, device=dev)         # the split step
    zkr, zki = zr[..., k & (n - 1)], zi[..., k & (n - 1)]
    znr, zni = zr[..., (n - k) & (n - 1)], zi[..., (n - k) & (n - 1)]
    even_r, even_i = 0.5 * (zkr + znr), 0.5 * (zki - zni)
    cr, ci = _cmul(0.5 * (zkr - znr), 0.5 * (zki + zni), table[:, 0],
                   table[:, 1])
    return torch.cat([even_r + ci, even_i - cr], dim=-1)


def istft_fft_mirror(re: torch.Tensor, im: torch.Tensor, frame_length: int,
                     frame_shift: int, window: str,
                     masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The FFT body of csrc/istft_tile.cuh step for step in plain torch:
    the raw overlap-add of the spectrum halves re, im (B, T, F), (B,
    (T-1)*hop + L) like `istft_ola_plain`; with masks (B, K, T, F), each
    channel's spectrum is mask * (re, im) and the result (B, K, ...) like
    `masked_ola_plain`.

    Same mask multiply, same Im of bins 0 and L/2 set to 0, the same
    inverse split step into conj Z (Z[n] = (X[n] + conj X[N-n]) + i W^-n
    (X[n] - conj X[N-n])), the forward stages of `_fft_stages_mirror`, the
    window times 1/L, and the overlap-add summed in ascending t. It uses no
    `torch.fft`. For the CPU tests and the card check of the kernels; no
    serving or training path calls it.
    """
    if istft_body(frame_length, frame_shift) != BODY_FFT:
        raise ValueError(f"the inverse FFT body takes a power-of-two frame "
                         f"length in [{FFT_MIN_LENGTH}, {FFT_MAX_LENGTH}] "
                         f"whose hop divides it at most "
                         f"{ISTFT_FFT_MAX_RATIO} times, got {frame_length} "
                         f"and {frame_shift}")
    dev = re.device
    n = frame_length // 2
    table = _twiddles(frame_length, dev)
    win = dsp_tables(frame_length, window, dev).win * (1.0 / frame_length)
    if masks is not None:
        m = masks.float()
        re, im = m * re[:, None], m * im[:, None]
    edge = torch.zeros(n + 1, dtype=torch.bool, device=dev)
    edge[0] = edge[n] = True
    im = im.masked_fill(edge, 0.0)
    k = torch.arange(n, device=dev)             # the inverse split step
    ar, ai, br, bi = re[..., k], im[..., k], re[..., n - k], im[..., n - k]
    dr, di = _cmul(ar - br, ai + bi, table[:n, 0], -table[:n, 1])
    yr, yi = _fft_stages_mirror((ar + br) - di, -((ai - bi) + dr),
                                frame_length, table)
    frames = torch.stack([yr * win[0::2], -yi * win[1::2]], dim=-1)
    frames = frames.flatten(-2)                 # (..., T, L)
    t, ratio = frames.shape[-2], frame_length // frame_shift
    acc = frames.new_zeros((*frames.shape[:-2], t + ratio - 1, frame_shift))
    for s in range(ratio - 1, -1, -1):          # ascending t in every row
        acc[..., s:s + t, :] += frames[..., s * frame_shift:
                                       (s + 1) * frame_shift]
    return acc.flatten(-2)


# ---------------------------------------------------------------------------
# K4: masked iSTFT
# ---------------------------------------------------------------------------


@table_cache
def _ola_norm(t: int, frame_length: int, frame_shift: int, window: str,
              device: torch.device) -> torch.Tensor:
    """1 / (overlap-added window squares) where nonzero, else 1."""
    win = get_window(window, frame_length)
    wsq = np.zeros((t - 1) * frame_shift + frame_length, np.float32)
    for ti in range(t):
        wsq[ti * frame_shift:ti * frame_shift + frame_length] += win ** 2
    norm = np.where(wsq > 1e-10, 1.0 / np.maximum(wsq, 1e-10), 1.0)
    return torch.as_tensor(norm.astype(np.float32), device=device)


def masked_istft(re: torch.Tensor, im: torch.Tensor, masks: torch.Tensor,
                 frame_length: int = 256, frame_shift: int = 128,
                 window: str = "hann", center: bool = True,
                 length: Optional[int] = None) -> torch.Tensor:
    """Resynthesis of K masked channels from the mixture spectrum.

    re/im (B, T, F) mixture spectrum halves, masks (B, K, T, F) real masks
    -> (B, K, length): istft(mask * spec) per channel, the mask multiply,
    iDFT, window and overlap-add fused in one kernel on the card. Needs
    frame_length % frame_shift == 0, as the TPU kernel does.
    """
    b, k, t, f = masks.shape
    want = (b, t, f)
    if tuple(re.shape) != want or tuple(im.shape) != want:
        raise ValueError(
            f"masked_istft: re/im must be the (B, T, F) mixture spectrum "
            f"matching masks (B, K, T, F)={tuple(masks.shape)}; got "
            f"re={tuple(re.shape)} im={tuple(im.shape)}, expected {want}")
    if f != _bins(frame_length):
        raise ValueError(f"masked_istft: {f} bins, expected "
                         f"{_bins(frame_length)} for L={frame_length}")
    _check_hop("masked_istft", frame_length, frame_shift)
    re, im, masks = re.contiguous(), im.contiguous(), masks.contiguous()
    if masks.is_cuda:
        ola = masked_ola_cuda(re, im, masks, frame_length, frame_shift,
                              window)
    else:
        ola = masked_ola_plain(re, im, masks, frame_length, frame_shift,
                               window)
    ola = ola * _ola_norm(t, frame_length, frame_shift, window, ola.device)
    return _trim(ola, t, frame_length, frame_shift, center, length)


def masked_ola_plain(re, im, masks, frame_length: int, frame_shift: int,
                     window: str) -> torch.Tensor:
    """K4's plain version: the raw overlap-add (B, K, (T-1)*hop + L)."""
    tab = dsp_tables(frame_length, window, re.device)
    bins = _bins(frame_length)
    m = masks.float()
    frames = (torch.matmul(m * re[:, None], tab.idft[:bins])
              + torch.matmul(m * im[:, None], tab.idft[bins:])) * tab.win
    return overlap_add(frames, frame_shift)


def masked_ola_cuda(re, im, masks, frame_length: int, frame_shift: int,
                    window: str, body: Optional[str] = None) -> torch.Tensor:
    """K4 on the card: csrc/masked_istft.cu, the raw overlap-add. `body`
    forces one of the inverse tile's two bodies; by default the shape
    decides (`istft_body`)."""
    b, k, t, f = masks.shape
    cuda_lib.check(re, "re", (torch.float32,), (b, t, f))
    cuda_lib.check(im, "im", (torch.float32,), (b, t, f))
    cuda_lib.check(masks, "masks", _FEAT_DTYPES)
    out_len = (t - 1) * frame_shift + frame_length
    out = torch.empty((b, k, out_len), dtype=torch.float32, device=re.device)
    _launch_istft("masked_istft", (re, im, masks), out, (b, k, t, f),
                  frame_length, frame_shift, window,
                  (int(masks.dtype == torch.bfloat16),), body)
    return out


def _launch_istft(name: str, spectrum, out: torch.Tensor, dims,
                  frame_length: int, frame_shift: int, window: str, tail,
                  body: Optional[str]) -> None:
    """Launch K4 or K10 into `out` (..., (T-1)*hop + L) with the tables of
    the body that runs: `istft_body`'s for the shape, unless `body` names
    one, for a check or a timing of one against the other."""
    dev = out.device
    chosen = body or istft_body(frame_length, frame_shift)
    win = dsp_tables(frame_length, window, dev).win
    tw, mre, mim = 0, 0, 0
    if chosen == BODY_FFT:
        tw = _twiddles(frame_length, dev)
    else:
        mre, mim = _idft_halves(frame_length, dev)
    cuda_lib.launch(name, dev, *spectrum, win, tw, mre, mim, out, *dims,
                    frame_length, frame_shift, out.shape[-1], *tail,
                    _BODY_CODES[chosen])
    BODY_LAUNCHES[name, chosen] += 1


@table_cache
def _idft_halves(frame_length: int, device: torch.device):
    """iDFT rows for Re and for Im, each (F, L) contiguous."""
    idft = torch.as_tensor(idft_matrix(frame_length), device=device)
    bins = _bins(frame_length)
    return idft[:bins].contiguous(), idft[bins:].contiguous()


# ---------------------------------------------------------------------------
# K9: STFT, packed [Re | Im]
# ---------------------------------------------------------------------------


def stft_ri(x: torch.Tensor, frame_length: int = 256, frame_shift: int = 128,
            window: str = "hann", center: bool = True) -> torch.Tensor:
    """(B, N) f32 -> (B, T, 2F) f32 with [Re | Im] halves on the last axis.

    Same conventions as `ops.stft.stft` (librosa center / reflect), in
    packed-real form. The reflect pad is a torch op before the kernel, as
    in JAX. Needs frame_length % frame_shift == 0, as the TPU kernel does.
    """
    _check_input(x, "stft_ri", "the STFT kernel (K9)", 2)
    _check_hop("stft_ri", frame_length, frame_shift)
    if center:
        x = reflect_pad(x, frame_length // 2)
    x = x.contiguous()
    half = stft_ri_cuda if x.is_cuda else stft_ri_plain
    return half(x, frame_length, frame_shift, window)


def stft_ri_plain(xpad: torch.Tensor, frame_length: int, frame_shift: int,
                  window: str) -> torch.Tensor:
    """K9's plain version on the (padded) signal (B, Np)."""
    tab = dsp_tables(frame_length, window, xpad.device)
    frames = xpad.unfold(-1, frame_length, frame_shift) * tab.win
    return torch.matmul(frames, tab.dft)


def stft_ri_cuda(xpad: torch.Tensor, frame_length: int, frame_shift: int,
                 window: str, body: Optional[str] = None) -> torch.Tensor:
    """K9 on the card: csrc/stft_ri.cu on the (padded) signal (B, Np), the
    same tile and the same two bodies as K1 (`stft_features_cuda`)."""
    cuda_lib.check(xpad, "x", (torch.float32,))
    b, n_pad = xpad.shape
    t = 1 + (n_pad - frame_length) // frame_shift
    out = torch.empty((b, t, 2 * _bins(frame_length)), dtype=torch.float32,
                      device=xpad.device)
    _launch_stft("stft_ri", xpad, (out,), (b, n_pad, t), frame_length,
                 frame_shift, window, (), body)
    return out


def stft_kernel(x: torch.Tensor, frame_length: int = 256,
                frame_shift: int = 128, window: str = "hann",
                center: bool = True) -> torch.Tensor:
    """Complex-output wrapper of `stft_ri`, with `ops.stft.stft`'s
    signature: (B, N) f32 -> complex64 (B, T, F)."""
    ri = stft_ri(x, frame_length, frame_shift, window, center)
    bins = _bins(frame_length)
    return torch.complex(ri[..., :bins], ri[..., bins:])


# ---------------------------------------------------------------------------
# K10: iSTFT of a packed spectrum
# ---------------------------------------------------------------------------


def istft_ri(spec_ri: torch.Tensor, frame_length: int = 256,
             frame_shift: int = 128, window: str = "hann",
             center: bool = True, length: Optional[int] = None
             ) -> torch.Tensor:
    """(B, T, 2F) f32 [Re | Im] -> (B, length) waveforms.

    The iDFT, the synthesis window and the overlap-add run in one kernel on
    the card; the window-square normalisation (a constant table), the
    center trim and the length contract (default (T-1)*hop when centered,
    cut or zero-padded to `length`) are elementwise torch ops outside, as
    in JAX. Needs frame_length % frame_shift == 0, as the TPU kernel does.
    """
    _check_input(spec_ri, "istft_ri", "the iSTFT kernel (K10)", 3)
    _check_hop("istft_ri", frame_length, frame_shift)
    t = spec_ri.shape[1]
    if spec_ri.shape[2] != 2 * _bins(frame_length):
        raise ValueError(f"istft_ri: last axis {spec_ri.shape[2]}, expected "
                         f"2F = {2 * _bins(frame_length)} for "
                         f"L={frame_length}")
    spec_ri = spec_ri.contiguous()
    half = istft_ola_cuda if spec_ri.is_cuda else istft_ola_plain
    ola = half(spec_ri, frame_length, frame_shift, window)
    ola = ola * _ola_norm(t, frame_length, frame_shift, window, ola.device)
    return _trim(ola, t, frame_length, frame_shift, center, length)


def istft_ola_plain(spec_ri: torch.Tensor, frame_length: int,
                    frame_shift: int, window: str) -> torch.Tensor:
    """K10's plain version: the raw overlap-add (B, (T-1)*hop + L)."""
    tab = dsp_tables(frame_length, window, spec_ri.device)
    return overlap_add(torch.matmul(spec_ri, tab.idft) * tab.win, frame_shift)


def istft_ola_cuda(spec_ri: torch.Tensor, frame_length: int,
                   frame_shift: int, window: str,
                   body: Optional[str] = None) -> torch.Tensor:
    """K10 on the card: csrc/istft_ri.cu, the raw overlap-add, on the same
    tile and the same two bodies as K4 (`masked_ola_cuda`)."""
    f = _bins(frame_length)
    b, t = spec_ri.shape[:2]
    cuda_lib.check(spec_ri, "spec_ri", (torch.float32,), (b, t, 2 * f))
    out = torch.empty((b, (t - 1) * frame_shift + frame_length),
                      dtype=torch.float32, device=spec_ri.device)
    _launch_istft("istft_ri", (spec_ri,), out, (b, t, f), frame_length,
                  frame_shift, window, (), body)
    return out


def istft_kernel(spec: torch.Tensor, frame_length: int = 256,
                 frame_shift: int = 128, window: str = "hann",
                 center: bool = True, length: Optional[int] = None
                 ) -> torch.Tensor:
    """Complex-input wrapper of `istft_ri`, with `ops.stft.istft`'s
    signature: complex (B, T, F) -> (B, length)."""
    ri = torch.cat([spec.real, spec.imag], dim=-1).float()
    return istft_ri(ri, frame_length, frame_shift, window, center, length)
