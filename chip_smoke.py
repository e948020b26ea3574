#!/usr/bin/env python3
"""Smoke test of the PyTorch port (dl4ss_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from dl4ss_tpu_torch/csrc, then:
  1. card and build: the card's name and power limit, the build time;
  2. kernel checks: each kernel against its plain PyTorch version on the
     card, at the shapes the serving path gives it, with its tolerance;
  3. round trip: STFT features then masked iSTFT with all-ones masks
     reconstructs the waveform;
  4. end to end: the torch_multi preset at full width (2-layer BiGRU-300,
     F*E = 129*50), random weights from a seed — one B=16 batch and 8 B=1
     requests through serve.separate_waveforms, with the launch counters
     zeroed just before and read just after; outputs finite and close to
     the same model's plain path (kernel flags off);
  5. CLI: run.separate on two synthetic wavs writes four wavs;
  6. timing: CUDA-event medians of each kernel, its plain version and a
     one-call library yardstick, the end-to-end batch and request times,
     and a torch.profiler breakdown of one batch and one request.
It prints a `kernels` JSON line, the nvidia-smi line, and last
`{"ok": true, "device": {...}}`. Any failed phase exits non-zero before
those lines; so does a machine without CUDA.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

SEED = 0
N_SAMPLES = 40000           # 5 s at 8 kHz: the reference utterance
BATCH = 16                  # the serving batch (bench.py)
REQUESTS = 8                # B=1 requests

# Published H100 SXM peaks (NVIDIA data sheet), for the bound column.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12           # CUDA cores, float32
BF16_TC_FLOPS = 989e12      # tensor cores, dense bf16

TOL = {"stft_features": 1e-4, "gru_fwd": 1e-4, "gru_fwd_bf16": 2e-2,
       "maskhead_fwd": 2e-2, "masked_istft": 1e-4, "round_trip": 1e-4,
       "end_to_end_rel": 2e-2}


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def check(name: str, err: float, tol: float) -> float:
    ok = bool(np.isfinite(err)) and err <= tol
    print(f"check {name}: max_abs_err={err:.3e} tol={tol:.0e} "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} max_abs_err {err} exceeds {tol}")
    return err


def max_err(a, b) -> float:
    return float((a.float() - b.float()).abs().max())


def device_ms(torch, fn, iters: int = 20) -> float:
    """Median device time of one call of `fn`, by CUDA events. The stream
    is held by a sleep kernel while every call is queued, so the events
    bracket the device work and not the host's enqueue."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        fn()
    host_s = (time.perf_counter() - t0) / 3
    torch.cuda.synchronize()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda._sleep(int(min(2.0 * host_s * iters + 1e-3, 4.0) * 2e9))
    for start, end in events:
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in events)


def host_ms(torch, fn, iters: int) -> float:
    """Median wall time of one synchronised call (a request's latency)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def profile_ms(torch, fn, top: int = 8):
    """Device time of one call of `fn` by kernel name, from torch.profiler
    (CUPTI): (busy ms, [(name, launches, ms), ...] largest first)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name = {}
    for evt in prof.events():
        if evt.device_type == torch.autograd.DeviceType.CUDA:
            n, ms = by_name.get(evt.name, (0, 0.0))
            by_name[evt.name] = (n + 1, ms + evt.time_range.elapsed_us() / 1e3)
    rows = sorted(((k, n, ms) for k, (n, ms) in by_name.items()),
                  key=lambda r: -r[2])
    return sum(r[2] for r in rows), rows[:top]


def rfft_flops(frames: int, length: int) -> float:
    """Operations of `frames` real FFTs of `length` points, ~2.5 L log2 L
    each: the least work of a (inverse) real DFT, which K1 and K4 compute
    as direct products."""
    return frames * 2.5 * length * np.log2(length)


def bound(nbytes: float, t_ops: float):
    """Least time in ms for the work: bytes at the HBM rate vs operations
    (already divided by their peak rates, in seconds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    from dl4ss_tpu_torch import preset, resolve_device
    from dl4ss_tpu_torch.models import init_separator
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import maskhead_kernels as k3
    from dl4ss_tpu_torch.ops import rnn_kernels as k2
    from dl4ss_tpu_torch.ops import stft_kernels as k14
    from dl4ss_tpu_torch.ops.stft import reflect_pad
    from dl4ss_tpu_torch.serve import separate_waveforms

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = resolve_device("cuda")
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"build: {len(cuda_lib.SOURCES)} kernels, nvcc "
          f"{lib.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s "
          f"-> {lib.path.name}", flush=True)
    for line in lib.log.splitlines():
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip(), file=sys.stderr)

    cfg = preset("torch_multi")
    L, hop, F = cfg.frame_length, cfg.frame_shift, cfg.freq_bins
    H, E, K = cfg.hidden_units, cfg.embedding_size, cfg.top_k
    rng = np.random.default_rng(SEED)

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev
                               ).to(dtype).contiguous()

    # ---- 2. kernel checks at the serving shapes (B=16) -------------------
    wav = tensor(rng.uniform(-1, 1, (BATCH, N_SAMPLES)))
    xpad = reflect_pad(wav, L // 2).contiguous()
    feat_c = k14.stft_features_cuda(xpad, L, hop, cfg.window, torch.float32)
    feat_p = k14.stft_features_plain(xpad, L, hop, cfg.window, torch.float32)
    errs = {"stft_features": check("K1 stft_features", max(
        max_err(a, b) for a, b in zip(feat_c, feat_p)), TOL["stft_features"])}
    _, re, im = feat_c
    T = re.shape[1]

    scale = 1.0 / np.sqrt(H)
    xp = tensor(0.5 * rng.standard_normal((T, 2, BATCH, 3 * H)))
    wh = tensor(rng.uniform(-scale, scale, (2, H, 3 * H)))
    bhn = tensor(rng.uniform(-scale, scale, (2, 1, H)))
    errs["gru_fwd"] = check("K2 gru_fwd f32", max_err(
        k2.gru_scan_cuda(xp, wh, bhn), k2.gru_scan_plain(xp, wh, bhn)),
        TOL["gru_fwd"])
    xpb, whb = xp.to(torch.bfloat16), wh.to(torch.bfloat16)
    check("K2 gru_fwd bf16", max_err(k2.gru_scan_cuda(xpb, whb, bhn),
                                     k2.gru_scan_plain(xpb, whb, bhn)),
          TOL["gru_fwd_bf16"])

    d2 = 2 * H
    hb = tensor(rng.uniform(-1, 1, (BATCH, T, d2)), torch.bfloat16)
    s2 = 1.0 / np.sqrt(d2)
    wb = tensor(rng.uniform(-s2, s2, (d2, F * E)), torch.bfloat16)
    bias = tensor(rng.uniform(-s2, s2, (F * E,)))
    qb = tensor(rng.standard_normal((BATCH, K, E)), torch.bfloat16)
    k3_args = (hb, wb, bias, qb, F, E, torch.float32)
    errs["maskhead_fwd"] = check("K3 maskhead_fwd", max_err(
        k3.fused_dot_masks_cuda(*k3_args), k3.fused_dot_masks_plain(*k3_args)),
        TOL["maskhead_fwd"])

    masks = tensor(rng.uniform(0, 1, (BATCH, K, T, F)))
    k4_args = (re, im, masks, L, hop, cfg.window)
    errs["masked_istft"] = check("K4 masked_istft", max_err(
        k14.masked_ola_cuda(*k4_args), k14.masked_ola_plain(*k4_args)),
        TOL["masked_istft"])

    # ---- 3. round trip ----------------------------------------------------
    ones = torch.ones((BATCH, 1, T, F), device=dev)
    _, re1, im1 = k14.stft_features(wav, L, hop, cfg.window)
    rec = k14.masked_istft(re1, im1, ones, L, hop, cfg.window)[:, 0]
    if rec.shape[-1] != (T - 1) * hop:
        fail(f"round trip length {rec.shape[-1]} != {(T - 1) * hop}")
    check("round trip K1->K4", max_err(rec, wav[:, :rec.shape[-1]]),
          TOL["round_trip"])

    # ---- 4. end to end: torch_multi at full width -------------------------
    model = init_separator(cfg, torch.Generator().manual_seed(SEED), dev)
    plain_cfg = cfg.replace(use_pallas_stft=False, use_pallas_rnn=False,
                            use_pallas_maskhead=False)
    spk = torch.as_tensor(rng.integers(0, cfg.num_speakers, (BATCH, K)),
                          device=dev)
    reqs = [(tensor(rng.uniform(-1, 1, (1, N_SAMPLES))),
             torch.as_tensor(rng.integers(0, cfg.num_speakers, (1, K)),
                             device=dev)) for _ in range(REQUESTS)]
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    out16 = separate_waveforms(model, wav, cfg, spk, length=N_SAMPLES)
    outs1 = [separate_waveforms(model, w, cfg, s, length=N_SAMPLES)
             for w, s in reqs]
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"main path launches: {launches}", flush=True)
    missing = [n for n in cuda_lib.KERNELS if not launches.get(n)]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    ref16 = separate_waveforms(model, wav, plain_cfg, spk, length=N_SAMPLES)
    refs1 = [separate_waveforms(model, w, plain_cfg, s, length=N_SAMPLES)
             for w, s in reqs]
    for name, got, ref, shape in (
            [(f"B={BATCH}", out16, ref16, (BATCH, K, N_SAMPLES))]
            + [(f"B=1 #{i}", o, r, (1, K, N_SAMPLES))
               for i, (o, r) in enumerate(zip(outs1, refs1))]):
        if tuple(got.shape) != shape or not bool(torch.isfinite(got).all()):
            fail(f"end to end {name}: shape {tuple(got.shape)} (want "
                 f"{shape}) or non-finite values")
        rel = float((got - ref).norm() / ref.norm())
        print(f"end to end {name}: rel_l2_vs_plain={rel:.3e} "
              f"max_abs={max_err(got, ref):.3e} tol_rel="
              f"{TOL['end_to_end_rel']:.0e}", flush=True)
        if not rel <= TOL["end_to_end_rel"]:
            fail(f"end to end {name} differs from the plain path: {rel}")

    # ---- 5. CLI -----------------------------------------------------------
    from dl4ss_tpu_torch.data.wavio import write_wav
    from dl4ss_tpu_torch.run import separate as separate_cli
    with tempfile.TemporaryDirectory() as tmp:
        paths = []
        for i in range(2):
            paths.append(os.path.join(tmp, f"mix{i}.wav"))
            write_wav(paths[-1], rng.uniform(-0.5, 0.5, N_SAMPLES),
                      cfg.frame_rate)
        out_dir = os.path.join(tmp, "out")
        separate_cli.main([*paths, "--speakers", "0,1", "--out", out_dir,
                           "--device", "cuda"])
        wrote = sorted(os.listdir(out_dir))
        if len(wrote) != 4:
            fail(f"CLI wrote {wrote}, expected 4 wavs")
        print(f"CLI: wrote {len(wrote)} wavs", flush=True)

    # ---- 6. timing ----------------------------------------------------------
    B, D = BATCH, 2
    hann = torch.hann_window(L, periodic=True, device=dev)
    spec = torch.complex(masks * re[:, None], masks * im[:, None])
    spec = spec.reshape(B * K, T, F).transpose(1, 2).contiguous()
    gru = torch.nn.GRU(d2, H, batch_first=True, bidirectional=True).to(dev)
    gru_in = torch.randn((B, T, d2), device=dev)
    rows = {
        "stft_features": dict(
            source="dl4ss_tpu_torch/csrc/stft_features.cu",
            replaces="dl4ss_tpu/ops/pallas_stft.py:123",
            kernel=lambda: k14.stft_features_cuda(xpad, L, hop, cfg.window,
                                                  torch.float32),
            plain=lambda: k14.stft_features_plain(xpad, L, hop, cfg.window,
                                                  torch.float32),
            library=lambda: torch.stft(wav, L, hop, window=hann, center=True,
                                       pad_mode="reflect",
                                       return_complex=True),
            # the padded wav in, |X|, Re X, Im X out; window: L multiplies,
            # |X|: 4 operations per bin
            bytes=4 * (xpad.numel() + 3 * B * T * F),
            t_ops=(rfft_flops(B * T, L) + B * T * L + 4 * B * T * F)
            / F32_FLOPS),
        "gru_fwd": dict(
            source="dl4ss_tpu_torch/csrc/gru_fwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:104",
            kernel=lambda: k2.gru_scan_cuda(xp, wh, bhn),
            plain=lambda: k2.gru_scan_plain(xp, wh, bhn),
            library=lambda: gru(gru_in),
            bytes=4 * (xp.numel() + wh.numel() + bhn.numel() + T * D * B * H),
            t_ops=T * D * B * (2 * H * 3 * H + 12 * H) / F32_FLOPS),
        "maskhead_fwd": dict(
            source="dl4ss_tpu_torch/csrc/maskhead_fwd.cu",
            replaces="dl4ss_tpu/ops/pallas_maskhead.py:59",
            kernel=lambda: k3.fused_dot_masks_cuda(*k3_args),
            plain=lambda: k3.fused_dot_masks_plain(*k3_args),
            library=None,
            bytes=2 * (hb.numel() + wb.numel() + qb.numel())
            + 4 * (bias.numel() + B * K * T * F),
            t_ops=2 * B * T * d2 * F * E / BF16_TC_FLOPS
            + (2 * B * T * F * E + 2 * K * B * T * F * E + 4 * B * K * T * F)
            / F32_FLOPS),
        "masked_istft": dict(
            source="dl4ss_tpu_torch/csrc/masked_istft.cu",
            replaces="dl4ss_tpu/ops/pallas_stft.py:206",
            kernel=lambda: k14.masked_ola_cuda(*k4_args),
            plain=lambda: k14.masked_ola_plain(*k4_args),
            library=lambda: torch.istft(spec, L, hop, window=hann,
                                        center=True, length=N_SAMPLES),
            # Re X, Im X and the masks in, the overlap-added frames out;
            # masking: 2 multiplies per bin, window and overlap-add: 2 per
            # sample
            bytes=4 * (re.numel() + im.numel() + masks.numel()
                       + B * K * ((T - 1) * hop + L)),
            t_ops=(rfft_flops(B * K * T, L) + 2 * B * K * T * L
                   + 2 * B * K * T * F) / F32_FLOPS),
    }
    kernels = []
    with torch.inference_mode():
        for name, r in rows.items():
            slow = name == "gru_fwd"
            ms = device_ms(torch, r["kernel"], 5 if slow else 20)
            plain_ms = device_ms(torch, r["plain"], 3 if slow else 10)
            lib_ms = (device_ms(torch, r["library"], 10)
                      if r["library"] else None)
            bound_ms, bound_by = bound(r["bytes"], r["t_ops"])
            kernels.append(dict(
                name=name, route="cuda", source=r["source"],
                replaces=r["replaces"], launches=launches[name],
                max_abs_err=errs[name], ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by, library_ms=lib_ms))
            print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
                  f"ms, library {lib_ms} ms, bound {bound_ms:.4f} ms "
                  f"({bound_by})", flush=True)
        pack_ms = device_ms(torch, lambda: k3.pack_w(wb, F, E), 10)
        print(f"time maskhead_pack (K3's W layout, once per weight version, "
              f"bf16 W): {pack_ms:.4f} ms", flush=True)
        gru_host = host_ms(torch, rows["gru_fwd"]["kernel"], 5)
        print(f"time gru_fwd host-paced (one call, synchronised): "
              f"{gru_host:.4f} ms", flush=True)
        batch_ms = host_ms(torch, lambda: separate_waveforms(
            model, wav, cfg, spk, length=N_SAMPLES), 5)
        req_ms = host_ms(torch, lambda: separate_waveforms(
            model, reqs[0][0], cfg, reqs[0][1], length=N_SAMPLES), 10)
        plain_batch_ms = host_ms(torch, lambda: separate_waveforms(
            model, wav, plain_cfg, spk, length=N_SAMPLES), 3)
        # the B=1 request's kernels alone, at its own shapes
        w1, s1 = reqs[0]
        x1 = reflect_pad(w1, L // 2).contiguous()
        _, re_1, im_1 = k14.stft_features_cuda(x1, L, hop, cfg.window,
                                               torch.float32)
        one = {
            "stft_features": lambda: k14.stft_features_cuda(
                x1, L, hop, cfg.window, torch.float32),
            "gru_fwd": lambda: k2.gru_scan_cuda(
                xp[:, :, :1].contiguous(), wh, bhn),
            "maskhead_fwd": lambda: k3.fused_dot_masks_cuda(
                hb[:1], wb, bias, qb[:1], F, E, torch.float32),
            "masked_istft": lambda: k14.masked_ola_cuda(
                re_1, im_1, masks[:1], L, hop, cfg.window)}
        print("time at B=1: " + ", ".join(
            f"{n} {device_ms(torch, f, 5):.4f} ms" for n, f in one.items()),
            flush=True)
        for label, fn, wall in (
                (f"B={BATCH} batch", lambda: separate_waveforms(
                    model, wav, cfg, spk, length=N_SAMPLES), batch_ms),
                ("B=1 request", lambda: separate_waveforms(
                    model, w1, cfg, s1, length=N_SAMPLES), req_ms)):
            busy, rows = profile_ms(torch, fn)
            print(f"profile {label}: device busy {busy:.3f} ms of "
                  f"{wall:.3f} ms wall (idle {1 - busy / wall:.1%})",
                  flush=True)
            for name, n, ms in rows:
                print(f"  {ms:9.4f} ms {n:5d}x {name[:90]}", flush=True)
    print(f"end to end: {batch_ms:.3f} ms per B={BATCH} batch "
          f"({BATCH / batch_ms * 1e3:.1f} mixtures/s), {req_ms:.3f} ms per "
          f"B=1 request; plain path {plain_batch_ms:.3f} ms per B={BATCH} "
          f"batch", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
