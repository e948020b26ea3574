#!/usr/bin/env python3
"""Checks of the PyTorch port (dl4ss_tpu_torch) on one NVIDIA GPU that
neither the card tests (`pytest -m cuda tests/`) nor the benchmark
(`benchmark/`) make, and the kernel timings of PERF.md's kernel table.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from dl4ss_tpu_torch/csrc, then:
  1. card and build: the card's name and power limit, the build time, the
     registers and spills of the resident chains and of K3 / K6;
  3. round trips: STFT features then masked iSTFT with all-ones masks, and
     the packed STFT then iSTFT through the public `ops` exports (both on
     the FFT bodies), reconstruct the waveform;
  4. serving at full width: the torch_multi preset (2-layer BiGRU-300,
     F*E = 129*50, 2-layer BiLSTM-300 classifier), random weights from a
     seed, one B=16 batch and 8 B=1 requests through
     serve.separate_waveforms with given and with classifier-selected
     speakers against the same model's plain path (kernel flags off), the
     selected speakers equal to the plain path's, and every launch counted
     and on the body the shape rule names;
  5. CLI: run.separate with --speakers and with --mode recursive;
  6. train steps: one torch_multi joint step and one classifier step at
     full width on the card against the same step on a CPU copy of the
     model and batch: loss, grad norm or accuracy, every update;
  7. trainers: run.train and run.classify at full width, every step's loss
     finite, the launches of the runs and of one step of each;
  8. kernels at the path shapes (B=16, T=313, D=2, H=300 and 600): each
     (K1-K10 and the dW + dh products) held against its plain version,
     also in bf16, at B=1, 32 and 128 and on both bodies where it has two,
     and the FFT bodies against their mirrors; then CUDA-event medians of
     each beside its plain version, a library yardstick and its bound, and
     the body sweeps the shape rules follow (RESIDENT_MAX_CHUNKS: K2 and
     K7 by batch; WIDE_MAX_BATCH: K7 at H=600; K5 and K8 both bodies at
     every shape);
  9. persistence: run.train saves 2 epochs, --resume adds a third, equal
     to an unbroken 3-epoch run; K3 after a restore; run.separate and
     run.evaluate from the checkpoint;
 10. TDAA at full width: serving against the plain path, one dense and
     one adversarial step against a CPU copy (losses, every gradient and
     every update), the classifier step at H=600, remat, tdaa_crm,
     tdaa_recursive, each with its launches;
 11. the learning check: 1,000 steps of run.train must raise the held-out
     SI-SDR of run.evaluate by at least 1 dB;
 12. data sources and scoring on a rehearsal corpus that the port writes
     (101 speakers, 5 s, k = 1, 2, 3 lists): the native loader against the
     plain one, a list batch on the card against the CPU's, the device
     prefetch against synchronous copies, run.train from the speaker tree
     and from the lists and run.classify from the lists, each step
     launching what its bank-driven one does, a list-driven resume against
     the unbroken run, BSS-Eval on the card against the float64 oracle
     (and its time a batch), run.evaluate --bss-eval and run.score;
 13. the memory, image-query and video generations at full width: the
     cocktail memory mode's resume, wavlists and evaluations, one step of
     each preset held to the launches its flags send, the query BiLSTMs
     on K7 / K8 against their plain loop, a memory and a video-query step
     on the card against the CPU, the frozen Inception trunk unmoved by a
     step, and the two learning gates (cocktail memory's dev MSE after
     1,000 steps at most 0.8 of step 0's; grid_video's held-out SI-SDR
     gain over 500 steps, the mean over seeds 0-7, at least JAX's mean
     less 1.5 standard deviations, tools/grid_video_jax_curve.py);
 14. parallel and utils: run.train --dp auto on one card bit-equal to the
     run without --dp, --dp 2 refused, two gloo ranks on cuda:0 running a
     joint and a memory step held to one rank, StepTimer, profile_trace
     and seed_everything;
 15. the public surface: every module imports without JAX, the surface
     map resolves, K2, K5, K7 and K8 with D = 1 at B=16, T=313, H=300
     against their plain versions and timed, the one-direction stacks
     through bidirectional_rnn against the plain loop, native.resample_poly
     against scipy.

(Phase 2, the kernels' inputs, feeds phases 3 and 8; the kernels' other
shapes and properties are tests/test_torch_cuda.py's, run on the card with
`pytest -m cuda`.)

    python3 chip_smoke.py --learning STEPS

runs phase 11 alone for STEPS steps (a multiple of 1,000), scored every
1,000 steps;

    python3 chip_smoke.py --rehearsal

runs phase 12 alone at the official wsj0-2mix depth (135 utterances a
speaker, 20,000 / 5,000 / 3,000 entries);

    python3 chip_smoke.py --generations | --parallel | --surface

build the kernels and run phase 13, 14 or 15 alone;

    python3 chip_smoke.py --cards

needs an even number of cards, two or more (one rank a card over NCCL):
phase 14's joint and memory steps on a dp = cards mesh and the joint step
on a dp = cards / 2 x mp = 2 mesh (104 speakers, so that the embedding
table's rows split), each held to one rank at phase 14's gates, then
run.train --dp auto and --dp cards / 2 --mp 2 against the run without
--dp (their largest parameter difference printed, not gated).

The modes print no `ok` line. The default run prints a `kernels` JSON
line, the nvidia-smi line, and last `{"ok": true, "device": {...}}`. Any
failed check exits non-zero before those lines; so does a machine without
CUDA.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import io
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
TRAIN_STEPS = 4             # steps of the joint trainer run
CLASSIFY_STEPS = 8          # steps of the classifier trainer run
EVAL_BATCHES = 2            # held-out batches of its metric report
WIDE = 600                  # the TDAA classifier's BiLSTM width
BANK_UTTS = 2               # utterances per speaker in its synthetic bank
RESUME_STEPS = 4            # steps per epoch of the save / resume runs
LEARN_STEPS = 1000          # steps of the learning check (B=16)
LEARN_BATCHES = 8           # held-out batches it is scored on
# the data phase's rehearsal corpus (101 speakers, 5 s, k = 1, 2, 3 lists):
# utterances a speaker, the last `holdout` of them for cv / tt only, and
# list entries per k; SMOKE_DATA is cut in depth, REHEARSAL_DATA is the
# official wsj0-2mix depth (chip_smoke.py --rehearsal)
SMOKE_DATA = dict(utts=12, holdout=4, tr=1600, cv=160, tt=160)
REHEARSAL_DATA = dict(utts=135, holdout=10, tr=20000, cv=5000, tt=3000)
DATA_HEAD = 800             # list entries a k of the shorter runs
DATA_TREE_STEPS = 2         # steps of the speaker-tree runs
DATA_PLAIN_UTTS = 101       # utterances the plain loader decodes
DATA_PREFETCH = 8           # streamed batches through the prefetch
DATA_BSS_ORACLE = 4         # mixtures held to the float64 BSS-Eval
# the generations phase: its rehearsal corpus (speakers, utterances a
# speaker, the last 2 of them for the wavlists' dev and test), the steps an
# epoch of its CLI runs and of its resume check, and the steps of the memory
# learning gate
GEN_SPEAKERS = 12
GEN_UTTS = 6
GEN_STEPS = 2
GEN_RESUME_STEPS = 50
MEM_LEARN_STEPS = 1000
LEARN_SPEAKERS = 101        # the learning gates' tree: speakers and
LEARN_UTTS = 8              # utterances a speaker, and its seed
LEARN_TREE_SEED = 3
# both gates hold out each speaker's last LEARN_HELD_UTTS utterances where
# they score unseen ones: the grid_video gate, on the protocol of
# tools/grid_video_jax_curve.py, trains from each of VIDEO_LEARN_SEEDS for
# VIDEO_LEARN_STEPS steps at encoder depth 1 and is scored before and after
# on VIDEO_HELD_BATCHES batches of them; the memory gate's second run
# (printed, not gated) on MEM_HELD_BATCHES
LEARN_HELD_UTTS = 2
VIDEO_LEARN_STEPS = 500
VIDEO_HELD_BATCHES = 16
MEM_HELD_BATCHES = 16
VIDEO_LEARN_SEEDS = tuple(range(8))
SURFACE_LAYERS = 2          # depth of phase 15's one-direction stacks
PAR_STEPS = 2               # steps of the run.train --dp auto check

# Published H100 SXM peaks (NVIDIA data sheet), for the bound column.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12           # CUDA cores, float32
BF16_TC_FLOPS = 989e12      # tensor cores, dense bf16

TOL = {"round_trip": 1e-4, "end_to_end_rel": 2e-2,
       # each kernel against its plain version at the path shapes (phase 8)
       # and with D = 1 (phase 15): the max abs error of the outputs, the
       # relative L2 of a backward's. f32: summation order only. bf16: one
       # flipped rounding of h (forward) or da (backward) carries on
       # through the steps. K6: the recomputed g differs by summation
       # order, which can flip one bf16 rounding of de or dacc (2^-8)
       "stft_features": 1e-4, "maskhead_fwd": 2e-2, "masked_istft": 1e-4,
       "stft_ri": 1e-4, "istft_ri": 1e-4, "maskhead_bwd": 1e-2,
       "gru_fwd": 1e-4, "gru_bwd": 1e-4, "lstm_fwd": 1e-4, "lstm_bwd": 1e-4,
       "gru_fwd_bf16": 2e-2, "gru_bwd_bf16": 5e-2, "lstm_fwd_bf16": 2e-2,
       "lstm_bwd_bf16": 5e-2,
       # the FFT bodies against their mirrors, the same steps in plain
       # torch: they differ by the compiler's FMA contraction only
       "stft_mirror": 1e-5, "istft_mirror": 1e-5,
       # dW and dh as bf16-operand products with f32 output against the f32
       # products of the upcast operands: summation order only
       "dacc_products": 1e-3,
       # train step, kernel route on the card against the plain halves on
       # the CPU: the CPU test's bars (tests/test_torch_train.py), set by
       # the bf16 mask head
       "train_loss_rel": 2e-2, "train_update_rel": 5e-2,
       # the tdaa steps' update comparison leaves out elements whose CPU
       # gradient is within this many RMS of the leaf's card-vs-CPU
       # gradient difference; they may carry at most this share of the
       # leaf's gradient (L2)
       "sign_noise": 3.0, "sign_hidden": 1e-2,
       # selected speakers are compared where the plain path's top-k
       # probabilities are further apart than this
       "selection_gap": 1e-3,
       # a resumed run against the unbroken one on the card: the same
       # kernels on the same inputs in the same order; relative L2 of each
       # parameter and moment (0 when the two are bit-equal)
       "repeat_rel": 1e-6,
       # the learning check: held-out teacher-forced SI-SDR after
       # LEARN_STEPS steps must gain at least this over step 0 (dB)
       "learning_gain_db": 1.0,
       # the native loader against the numpy one (tests/test_native.py)
       "loader": 1e-6,
       # a list batch mixed on the card against the CPU's: a gather, a
       # normalisation and a gain in f32
       "list_batch": 1e-6,
       # BSS-Eval's f32 solves on the card against the float64 oracle, dB
       # (tests/test_eval.py's bar)
       "bss_db": 0.2,
       # run.score on the exported PCM16 wavs against run.evaluate's SDR, dB
       "score_db": 0.01,
       # a cocktail memory step on the card against the CPU: all f32 (K7 /
       # K8 f32, the plain align head), so summation order only: the loss
       # (relative), every gradient, the grad norm and every update
       # (relative L2), and the memory rows after the write (max abs)
       "mem_step_loss": 1e-5, "mem_step_update": 1e-3, "memory": 1e-5,
       # a grid_video step the same way: K3 / K6 run the mask head in bf16
       "video_step_loss": 1e-3, "video_step_update": 2e-2,
       # the query BiLSTMs on K7 / K8 against their plain loop on the card
       # (max abs of the output; relative L2 of each parameter's gradient):
       # K7 / K8's own bars
       "query_rnn_fwd": 2e-2, "query_rnn_bwd": 5e-2,
       # the learning gates: cocktail memory mode's dev MSE after
       # MEM_LEARN_STEPS steps as a share of step 0's at most; grid_video's
       # held-out SI-SDR gain after VIDEO_LEARN_STEPS steps, the mean over
       # VIDEO_LEARN_SEEDS, at least (dB): JAX's mean gain on the same
       # protocol and seeds (tools/grid_video_jax_curve.py, seeds 0-7:
       # mean 0.9847) less 1.5 times their standard deviation (0.1020)
       "memory_learn_ratio": 0.8, "video_learn_db": 0.83,
       # a dp=2 step (two ranks, each on its half of the B=16 batch, the
       # gradients all-reduced) against the same step on one rank, fixed
       # before any chip call: the joint step's bf16 mask head sets its
       # bars (the loss relative, each gradient and update relative L2),
       # the memory step is all f32 (as mem_step_* and memory above)
       "par_joint_loss": 1e-4, "par_joint_update": 5e-2,
       "par_mem_loss": 1e-5, "par_mem_update": 1e-3, "par_memory": 1e-5,
       # phase 15: the one-direction stacks on K2 / K7 and K5 / K8 (D = 1)
       # against their plain loop on the card, at the recurrent kernels'
       # bars (max abs of the output; relative L2 of each gradient), and
       # the native resampler against scipy (tests/test_native.py's bar)
       "uni_rnn_fwd": 2e-2, "uni_rnn_bwd": 5e-2, "resample": 5e-5}


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


def rel_l2(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


def check_rel(name: str, got, ref, tol: float) -> float:
    """Gate on the relative L2 error; returns the max abs error."""
    rel, err = rel_l2(got, ref), max_err(got, ref)
    ok = bool(np.isfinite(rel)) and rel <= tol
    print(f"check {name}: rel_l2={rel:.3e} max_abs_err={err:.3e} "
          f"tol_rel={tol:.0e} {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        fail(f"{name} relative L2 error {rel} exceeds {tol}")
    return err


def hold(label: str, got, ref, tol: float, rel: bool = False) -> float:
    """Each output of a call (a tensor or a tuple of them) against the
    reference's: the max abs error, or the relative L2 where `rel`.
    Returns the largest max abs error."""
    if not isinstance(got, (tuple, list)):
        got, ref = (got,), (ref,)
    return max(check_rel(f"{label} [{i}]", g, r, tol) if rel
               else check(f"{label} [{i}]", max_err(g, r), tol)
               for i, (g, r) in enumerate(zip(got, ref)))


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


def rfft_flops(frames: int, length: int) -> float:
    """Operations of `frames` real FFTs of `length` points, ~2.5 L log2 L
    each: the least work of a (inverse) real DFT, which the FFT bodies of
    K1, K4, K9 and K10 do (their direct bodies do 4 L F)."""
    return frames * 2.5 * length * np.log2(length)


def bound(nbytes: float, t_ops: float):
    """Least time in ms for the work: bytes at the HBM rate vs operations
    (already divided by their peak rates, in seconds)."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes > t_ops
                                       else "operations")


def quiet(fn, *args, **kwargs):
    """Call `fn` with its standard output captured: (value, text)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        value = fn(*args, **kwargs)
    return value, buf.getvalue()


def zero_counts(torch):
    """Set every launch counter to 0 (after the queued work is done)."""
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import rnn_kernels as k2
    from dl4ss_tpu_torch.ops import stft_kernels as k14
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    k2.BODY_LAUNCHES.clear()
    k14.BODY_LAUNCHES.clear()


def read_counts(torch, total=None):
    """(launches by kernel, recurrent launches by (kernel, body)); the
    launches are also added to the Counter `total` when one is given."""
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import rnn_kernels as k2
    torch.cuda.synchronize()
    launches = {n: c for n, c in cuda_lib.LAUNCHES.items() if c}
    if total is not None:
        total.update(launches)
    return launches, {k: c for k, c in k2.BODY_LAUNCHES.items() if c}


def expect_counts(path, got, want):
    """Fail unless the launches `got` include exactly `want` (kernel ->
    count; 0 means never launched)."""
    seen = {n: got.get(n, 0) for n in want}
    if seen != want:
        fail(f"{path}: launched {seen}, expected {want}")


def leaf_updates(path, before, after_g, after_c, tol, grads_g=None,
                 grads_c=None):
    """Every parameter's update on the card against the CPU's: the same
    leaves moved, each within `tol` relative L2. Returns the worst.

    Given the gradients each side's optimizer received (`recorded_grads`),
    each leaf's gradient is held to `tol` too, and every leaf's gradient
    rel L2 is printed. Adam's first step moves an element by ~lr * sign(g),
    so an element whose CPU gradient lies within the leaf's noise, no
    larger than TOL["sign_noise"] times the RMS of the card-vs-CPU gradient
    difference over the leaf, may move either way on either side: the
    update is compared on the other elements. The card enters that mask
    only through the one RMS per leaf (held to `tol` by the gradient
    check). Elements whose gradient is exactly zero on both sides stay in
    the comparison; those zero on one side only are counted apart. The
    elements left out may carry at most TOL["sign_hidden"] of the leaf's
    CPU gradient (L2). Everything is printed before a failure."""
    worst, g_rels, left_out, faults = 0.0, {}, {}, []
    for name, ref in after_c.items():
        want, got = ref - before[name], after_g[name] - before[name]
        if not np.any(want):
            if np.any(got):
                faults.append(f"the card moved {name}, which the CPU left")
            continue
        keep = np.ones(want.shape, bool)
        if grads_c is not None:
            g_c, g_g = grads_c[name], grads_g[name]
            diff = g_g - g_c
            g_norm = float(np.linalg.norm(g_c))
            g_rel = float(np.linalg.norm(diff)) / g_norm
            g_rels[name] = g_rel
            if not g_rel <= tol:
                faults.append(f"gradient of {name} rel L2 {g_rel} exceeds "
                              f"{tol}")
            noise = TOL["sign_noise"] * float(np.sqrt(np.mean(diff ** 2)))
            both_zero = (g_c == 0) & (g_g == 0)
            keep = (np.abs(g_c) > noise) | both_zero
            out = int((~keep).sum())
            hidden = float(np.linalg.norm(g_c[~keep])) / g_norm
            if out or both_zero.any():
                left_out[name] = (out, int(((g_c == 0) != (g_g == 0)).sum()),
                                  int(both_zero.sum()), keep.size,
                                  f"{hidden:.1e}")
            if not hidden <= TOL["sign_hidden"]:
                faults.append(f"{name}: the {out} of {keep.size} gradient "
                              f"elements within its noise {noise:.3e} carry "
                              f"{hidden:.3e} of its gradient")
        rel = (float(np.linalg.norm((got - want)[keep])
                     / np.linalg.norm(want[keep])) if keep.any() else 0.0)
        worst = max(worst, rel)
        if not rel <= tol:
            faults.append(f"update of {name} rel L2 {rel} exceeds {tol}")
    if g_rels:
        name = max(g_rels, key=g_rels.get)
        print(f"{path}: gradient rel L2 by leaf (worst {g_rels[name]:.3e}, "
              f"{name}; tol {tol:.0e}): "
              + ", ".join(f"{n} {r:.2e}" for n, r in sorted(g_rels.items())),
              flush=True)
        print(f"{path}: gradient elements by leaf (left out of the update "
              f"comparison as within the leaf's noise, of which zero on one "
              f"side; zero on both sides, kept; all; the share of the "
              f"gradient's L2 left out, at most "
              f"{TOL['sign_hidden']:.0e}): {left_out}", flush=True)
    if faults:
        fail(f"{path}: " + "; ".join(faults))
    return worst


def recorded_grads(step, state, feats):
    """Run `step(state, feats)`, recording by parameter name the gradients
    that each optimizer update receives (before its clip)."""
    from dl4ss_tpu_torch.train import state as state_mod
    names = {id(p): n for n, p in state.model.named_parameters()}
    grads = {}
    update = state_mod.Optimizer.update

    def recording(self, params, g, opt_state, **kwargs):
        for p, x in zip(params, g):
            grads[names[id(p)]] = x.detach().float().cpu().numpy().copy()
        return update(self, params, g, opt_state, **kwargs)

    state_mod.Optimizer.update = recording
    try:
        return step(state, feats), grads
    finally:
        state_mod.Optimizer.update = update


def close_losses(path, met_g, met_c, keys, tol):
    for key in keys:
        got, ref = float(met_g[key]), float(met_c[key])
        rel = abs(got - ref) / max(abs(ref), 1e-12)
        print(f"{path} {key}: card {got:.6f} cpu {ref:.6f} rel {rel:.3e} "
              f"tol {tol:.0e}", flush=True)
        if not (np.isfinite(got) and rel <= tol):
            fail(f"{path} {key} differs: card {got}, cpu {ref}")


def check_bodies_on(torch, label, name, cuda, plain, args, outs, tol, rel):
    """K2, K5, K7 or K8: the body the shape rule names on this card (it
    must be the one a default call launches) and the stepwise one, or the
    resident one where the rule names the stepwise one and it can run, each
    against the plain version (max abs error, or relative L2 where `rel`);
    the resident, cluster or wide body (K7 past H=304) against the stepwise
    one and against a second call of itself, and the cluster body bit for
    bit against the resident one."""
    from dl4ss_tpu_torch.ops import rnn_kernels as k2
    hidden = args[1].shape[1]          # wh (D, H, NG * H)
    rule = k2.default_body(args[0].device, name, args[0].dtype, hidden,
                           args[0].shape[2], args[0].shape[1])

    def outputs(fn, **kw):          # K2 returns hs alone
        res = fn(*args, **kw)
        return (res,) if isinstance(res, torch.Tensor) else res

    def gate(what, g, r):
        return (check_rel(what, g, r, tol) if rel
                else check(what, max_err(g, r), tol))
    ref = outputs(plain)
    before = k2.BODY_LAUNCHES[name, rule]
    got = {rule: outputs(cuda)}
    if k2.BODY_LAUNCHES[name, rule] != before + 1:
        fail(f"{label}: the default call did not run the {rule} body")
    if rule != k2.BODY_STEPWISE:
        got[k2.BODY_STEPWISE] = outputs(cuda, body=k2.BODY_STEPWISE)
    elif hidden <= k2.RESIDENT_MAX_HIDDEN:
        got[k2.BODY_RESIDENT] = outputs(cuda, body=k2.BODY_RESIDENT)
    worst = {body: max(gate(f"{label} {body} body {what}", g, r)
                       for what, g, r in zip(outs, res, ref))
             for body, res in got.items()}
    if len(got) == 2:
        held = next(b for b in got if b != k2.BODY_STEPWISE)
        for what, g, r in zip(outs, got[held], got[k2.BODY_STEPWISE]):
            gate(f"{label} {held} against stepwise {what}", g, r)
        for what, g, g2 in zip(outs, got[held], outputs(cuda, body=held)):
            if not torch.equal(g, g2):
                fail(f"{label}: two {held} calls in a row differ in {what}")
    if rule == k2.BODY_CLUSTER:
        for what, g, r in zip(outs, got[rule],
                              outputs(cuda, body=k2.BODY_RESIDENT)):
            if not torch.equal(g, r):
                fail(f"{label}: the cluster body differs from the resident "
                     f"one in {what}")
    return worst[rule]


def persistence_phase(torch, dev, rng, tmp):
    """9. Checkpoints on the card: run.train saves 2 epochs, --resume adds
    a third, and the result equals an unbroken 3-epoch run; K3's packed W
    follows a restore (masks bit-equal to those before the weights moved);
    run.separate and run.evaluate (teacher-forced and top-k) from the
    checkpoint."""
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.data.synth import make_synthetic_bank
    from dl4ss_tpu_torch.data.wavio import write_wav
    from dl4ss_tpu_torch.models import separate
    from dl4ss_tpu_torch.ops import stft_kernels as k14
    from dl4ss_tpu_torch.run import evaluate as evaluate_cli
    from dl4ss_tpu_torch.run import separate as separate_cli
    from dl4ss_tpu_torch.run import train as train_cli
    from dl4ss_tpu_torch.train.checkpoint import (latest_step,
                                                  restore_checkpoint)
    from dl4ss_tpu_torch.train.steps import make_fused_step
    cfg = preset("torch_multi")
    ck = os.path.join(tmp, "ck")
    base = ["--preset", "torch_multi", "--epoch-size", str(RESUME_STEPS),
            "--utts", str(BANK_UTTS), "--seed", str(SEED), "--device", "cuda"]
    quiet(train_cli.main, [*base, "--epochs", "2", "--checkpoint-dir", ck])
    if latest_step(ck) != 2 * RESUME_STEPS:
        fail(f"run.train saved step {latest_step(ck)}, expected "
             f"{2 * RESUME_STEPS}")
    resumed, text = quiet(train_cli.main, [*base, "--epochs", "3",
                                           "--checkpoint-dir", ck,
                                           "--resume"])
    if "resuming under the checkpoint's config" not in text:
        fail("run.train --resume did not take the checkpoint's config")
    unbroken, _ = quiet(train_cli.main, [*base, "--epochs", "3"])
    pairs = list(zip(resumed.model.state_dict().values(),
                     unbroken.model.state_dict().values()))
    pairs += list(zip(resumed.opt_state.mu + resumed.opt_state.nu,
                      unbroken.opt_state.mu + unbroken.opt_state.nu))
    worst = max(rel_l2(a, b) for a, b in pairs)
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    print(f"resume: 2 epochs + --resume 1 against 3 unbroken epochs of "
          f"{RESUME_STEPS} steps: step {resumed.step} and {unbroken.step}, "
          f"{len(pairs)} tensors, worst rel L2 {worst:.3e} tol "
          f"{TOL['repeat_rel']:.0e}, bit-equal {bit_equal}", flush=True)
    if resumed.step != unbroken.step or not worst <= TOL["repeat_rel"]:
        fail(f"the resumed run differs from the unbroken one: {worst}")
    if not torch.equal(resumed.generator.get_state(),
                       unbroken.generator.get_state()):
        fail("the resumed run's batch generator is not the unbroken one's")

    # K3 packs W once per weight version: a train step moves W, and the
    # restore writes the saved W back in place; both must repack
    wav = torch.as_tensor(rng.uniform(-1, 1, (BATCH, N_SAMPLES)).astype(
        np.float32), device=dev)
    spk = torch.as_tensor(rng.integers(0, cfg.num_speakers, (BATCH, 2)),
                          device=dev)
    feat = k14.stft_features(wav, cfg.frame_length, cfg.frame_shift)[0]

    def masks():
        with torch.no_grad():
            return separate(resumed.model, feat, cfg, spk_idx=spk).masks
    bank = torch.as_tensor(make_synthetic_bank(
        SEED, cfg.num_speakers, BANK_UTTS, N_SAMPLES), device=dev)
    m_saved = masks()
    make_fused_step(cfg)(resumed, bank)
    m_moved = masks()
    zero_counts(torch)
    restore_checkpoint(ck, resumed)
    m_restored = masks()
    launches, _ = read_counts(torch)
    print(f"K3 after a restore: masks bit-equal to those before the train "
          f"step {torch.equal(m_saved, m_restored)}, changed by the step "
          f"{not torch.equal(m_saved, m_moved)}; launches of the restored "
          f"call {launches}", flush=True)
    if torch.equal(m_saved, m_moved) or not torch.equal(m_saved, m_restored):
        fail("K3's masks after the restore are not those before the step")
    # the restore wrote W in place: one repack, then K3
    expect_counts("K3 after a restore", launches,
                  {"maskhead_fwd": 1, "maskhead_pack": 1})

    # the separation and evaluation CLIs from the checkpoint
    paths = []
    for i in range(2):
        paths.append(os.path.join(tmp, f"ck_mix{i}.wav"))
        write_wav(paths[-1], rng.uniform(-0.5, 0.5, N_SAMPLES),
                  cfg.frame_rate)
    out_dir = os.path.join(tmp, "ck_out")
    zero_counts(torch)
    _, text = quiet(separate_cli.main, [*paths, "--checkpoint-dir", ck,
                                        "--out", out_dir, "--device",
                                        "cuda"])
    launches, _ = read_counts(torch)
    wrote = sorted(os.listdir(out_dir))
    print(f"run.separate --checkpoint-dir: {text.splitlines()[0]}; wrote "
          f"{len(wrote)} wavs; launches {launches}", flush=True)
    if len(wrote) != 4 or "restored step" not in text:
        fail(f"run.separate from the checkpoint wrote {wrote}")
    expect_counts("run.separate --checkpoint-dir", launches, {
        "stft_features": 1, "gru_fwd": cfg.encoder_layers,
        "lstm_fwd": cfg.classifier_layers, "maskhead_fwd": 1,
        "masked_istft": 1})
    scores = {}
    for label, extra in (("teacher-forced", ["--teacher-forced"]),
                         ("top-k", [])):
        scores[label], text = quiet(evaluate_cli.main, [
            "--checkpoint-dir", ck, "--batches", "2", "--utts",
            str(BANK_UTTS), "--seed", str(SEED), "--device", "cuda", *extra])
        print(f"run.evaluate --checkpoint-dir {label}: "
              f"{text.strip().splitlines()[-1]}", flush=True)
        if not np.isfinite(scores[label]):
            fail(f"run.evaluate {label}: SI-SDR {scores[label]}")
    return {"resume_bit_equal": bit_equal, "resume_worst_rel": worst}


def tdaa_phase(torch, dev, rng, wav, reqs):
    """10. TDAA at full width: the tdaa preset (4-layer BiLSTM-300 encoder,
    ADDJUST, discriminator, classifier BiLSTM at 2H = 600) serving a B=16
    batch and a B=1 request with given and with classifier-selected
    speakers against the plain path; one dense and one adversarial step on
    the card against the same steps on the CPU; remat's gradients against
    remat=False's; tdaa_crm serving one request and taking one dense step;
    tdaa_recursive peeling a request in two steps. Returns the launches by
    kernel of those paths (remat's comparison not counted)."""
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.data.synth import (featurize, make_synthetic_bank,
                                            sample_mixtures)
    from dl4ss_tpu_torch.models import init_separator
    from dl4ss_tpu_torch.ops import rnn_kernels as k2
    from dl4ss_tpu_torch.serve import (recursive_waveforms,
                                       select_and_separate,
                                       separate_waveforms)
    from dl4ss_tpu_torch.train.state import create_train_state
    from dl4ss_tpu_torch.train.steps import (_separation_loss,
                                             make_adversarial_step,
                                             make_classifier_step,
                                             make_dense_train_step)
    from dl4ss_tpu_torch.weights import export_jax_params, flatten_tree
    cfg = preset("tdaa")
    flags_off = dict(use_pallas_stft=False, use_pallas_rnn=False,
                     use_pallas_maskhead=False)
    plain = cfg.replace(**flags_off)
    K, layers, clayers = cfg.top_k, cfg.encoder_layers, cfg.classifier_layers
    res, step_, wide = k2.BODY_RESIDENT, k2.BODY_STEPWISE, k2.BODY_WIDE
    clu = k2.BODY_CLUSTER
    model = init_separator(cfg, torch.Generator().manual_seed(SEED), dev)
    total = collections.Counter()
    n_params = sum(p.numel() for p in model.parameters())
    print(f"tdaa: {n_params} parameters ({layers}-layer BiLSTM-"
          f"{cfg.hidden_units} encoder, ADDJUST, discriminator, "
          f"{clayers}-layer BiLSTM-"
          f"{cfg.hidden_units * cfg.classifier_hidden_mult} classifier)",
          flush=True)
    w1, s1 = reqs[0]
    spk = torch.as_tensor(rng.integers(0, cfg.num_speakers, (BATCH, K)),
                          device=dev)

    def compare(path, got, ref):
        rel = rel_l2(got, ref)
        print(f"{path}: rel_l2_vs_plain={rel:.3e} tol_rel="
              f"{TOL['end_to_end_rel']:.0e}", flush=True)
        if not bool(torch.isfinite(got).all()) or not rel <= TOL[
                "end_to_end_rel"]:
            fail(f"{path} differs from the plain path: {rel}")

    # serving, given speakers: K1, K7 on the encoder (cluster), K3 on
    # the ADDJUST queries, K4
    zero_counts(torch)
    out16 = separate_waveforms(model, wav, cfg, spk, length=N_SAMPLES)
    out1 = separate_waveforms(model, w1, cfg, s1, length=N_SAMPLES)
    launches, bodies = read_counts(torch, total)
    print(f"tdaa given-speaker serving (B={BATCH} + B=1): launches "
          f"{launches}, bodies {bodies}", flush=True)
    expect_counts("tdaa given-speaker serving", launches, {
        "stft_features": 2, "lstm_fwd": 2 * layers, "maskhead_fwd": 2,
        "masked_istft": 2, "lstm_bwd": 0})
    if bodies != {("lstm_fwd", clu): 2 * layers}:
        fail(f"tdaa given-speaker serving ran the bodies {bodies}")
    compare(f"tdaa given B={BATCH}", out16, separate_waveforms(
        model, wav, plain, spk, length=N_SAMPLES))
    compare("tdaa given B=1", out1, separate_waveforms(
        model, w1, plain, s1, length=N_SAMPLES))

    # classifier-selected: the classifier's BiLSTM-600 on K7's wide body,
    # one launch a layer (2 a selected call). Rows whose plain top-k is
    # clear must pick the same speakers; the waveforms are compared with
    # the plain path's speakers forced
    zero_counts(torch)
    sel16, spk16 = select_and_separate(model, wav, cfg, length=N_SAMPLES)
    sel1, spk1 = select_and_separate(model, w1, cfg, length=N_SAMPLES)
    launches, bodies = read_counts(torch, total)
    print(f"tdaa classifier-selected serving: launches {launches}, bodies "
          f"{bodies}", flush=True)
    expect_counts("tdaa classifier-selected serving", launches, {
        "stft_features": 2, "lstm_fwd": 2 * (layers + clayers),
        "maskhead_fwd": 2, "masked_istft": 2})
    if bodies != {("lstm_fwd", clu): 2 * layers,
                  ("lstm_fwd", wide): 2 * clayers}:
        fail(f"tdaa classifier-selected serving ran the bodies {bodies}")
    for label, mix, got_wav, got_spk in ((f"B={BATCH}", wav, sel16, spk16),
                                         ("B=1", w1, sel1, spk1)):
        ref_wav, ref_spk = select_and_separate(model, mix, plain,
                                               length=N_SAMPLES)
        if not torch.equal(got_spk, ref_spk):
            print(f"tdaa selected {label}: speakers {got_spk.tolist()} "
                  f"(plain {ref_spk.tolist()})", flush=True)
        forced = separate_waveforms(model, mix, cfg, ref_spk,
                                    length=N_SAMPLES)
        compare(f"tdaa selected {label} (the plain path's speakers)",
                forced, ref_wav)
        same = got_spk == ref_spk
        if bool(same.all(dim=-1).any()):
            rows = same.all(dim=-1)
            if max_err(got_wav[rows], forced[rows]) > 1e-6:
                fail(f"tdaa selected {label}: the selected run and the run "
                     f"forced to the same speakers differ")

    # one dense and one adversarial step on the card against the CPU
    bank = torch.as_tensor(make_synthetic_bank(
        SEED, cfg.num_speakers, BANK_UTTS, N_SAMPLES), device=dev)
    feats = featurize(sample_mixtures(torch.Generator().manual_seed(SEED),
                                      bank, cfg), cfg)
    cpu_feats = {k: v.cpu() for k, v in feats.items()}

    def leaves(m):
        return dict(flatten_tree(export_jax_params(m)))

    for name, make, keys, want in (
            ("dense", make_dense_train_step, ("loss", "mask_loss"),
             {"lstm_fwd": layers, "lstm_bwd": layers, "maskhead_fwd": 0,
              "maskhead_bwd": 0}),
            ("adversarial", make_adversarial_step,
             ("d_loss", "g_loss", "mask_loss", "sum_loss"),
             {"lstm_fwd": 2 * layers, "lstm_bwd": layers,
              "maskhead_fwd": 2, "maskhead_bwd": 1})):
        twin = copy.deepcopy(model).to("cpu")
        before = leaves(model)
        step = make(cfg)
        zero_counts(torch)
        (_, met_g), grads_g = recorded_grads(
            step, create_train_state(cfg, model=model), feats)
        launches, bodies = read_counts(torch, total)
        (_, met_c), grads_c = recorded_grads(
            step, create_train_state(cfg, model=twin, device="cpu"),
            cpu_feats)
        print(f"tdaa {name} step: launches {launches}, bodies {bodies}",
              flush=True)
        expect_counts(f"tdaa {name} step", launches, want)
        # every K7 launch is one chain of the cluster body, every K8 one
        # of the resident body
        if bodies != {("lstm_fwd", clu): want["lstm_fwd"],
                      ("lstm_bwd", res): want["lstm_bwd"]}:
            fail(f"tdaa {name} step ran the bodies {bodies}")
        close_losses(f"tdaa {name} step", met_g, met_c, keys,
                     TOL["train_loss_rel"])
        worst = leaf_updates(f"tdaa {name} step", before, leaves(model),
                             leaves(twin), TOL["train_update_rel"],
                             grads_g, grads_c)
        print(f"tdaa {name} step: {len(grads_c)} gradients and updates, "
              f"worst update rel L2 {worst:.3e} tol "
              f"{TOL['train_update_rel']:.0e}", flush=True)

    # the classifier trainer on tdaa: K7 at H=600 wide, K8 stepwise
    zero_counts(torch)
    make_classifier_step(cfg)(create_train_state(cfg, model=model), feats)
    launches, bodies = read_counts(torch, total)
    print(f"tdaa classifier step: launches {launches}, bodies {bodies}",
          flush=True)
    if bodies != {("lstm_fwd", wide): clayers, ("lstm_bwd", step_): clayers}:
        fail(f"tdaa classifier step ran the bodies {bodies}")

    # remat: the same gradients, bit for bit, from a recompute of each
    # encoder layer (K7 again) in the backward; the peak memory of each
    grads, peaks, counts = {}, {}, {}
    for remat in (False, True):
        c = cfg.replace(remat=remat)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        zero_counts(torch)
        loss, _ = _separation_loss(model, feats, c)
        params = [p for n, p in model.named_parameters()
                  if not n.startswith("discriminator.")]
        grads[remat] = torch.autograd.grad(loss, params, allow_unused=True)
        counts[remat], _ = read_counts(torch)
        peaks[remat] = torch.cuda.max_memory_allocated() / 2 ** 20
    same = all((a is None and b is None) or torch.equal(a, b)
               for a, b in zip(grads[False], grads[True]))
    print(f"tdaa remat: gradients bit-equal {same}; peak memory "
          f"{peaks[False]:.1f} MiB without, {peaks[True]:.1f} MiB with; "
          f"launches without {counts[False]}, with {counts[True]}",
          flush=True)
    if not same:
        fail("remat's gradients differ from remat=False's")
    if counts[True].get("lstm_fwd") != 2 * layers:
        fail(f"remat did not recompute the encoder layers: {counts[True]}")

    # tdaa_crm: one request (K1, K7; the plain cRM head and the plain
    # iSTFT, as in JAX) and one dense step
    ccfg = preset("tdaa_crm")
    cmodel = init_separator(ccfg, torch.Generator().manual_seed(SEED), dev)
    zero_counts(torch)
    crm1 = separate_waveforms(cmodel, w1, ccfg, s1, length=N_SAMPLES)
    launches, _ = read_counts(torch, total)
    print(f"tdaa_crm request: launches {launches}", flush=True)
    expect_counts("tdaa_crm request", launches, {
        "stft_features": 1, "lstm_fwd": layers, "maskhead_fwd": 0,
        "masked_istft": 0})
    compare("tdaa_crm B=1", crm1, separate_waveforms(
        cmodel, w1, ccfg.replace(**flags_off), s1, length=N_SAMPLES))
    cfeats = featurize(sample_mixtures(torch.Generator().manual_seed(SEED),
                                       bank, ccfg), ccfg)
    zero_counts(torch)
    _, cmet = make_dense_train_step(ccfg)(
        create_train_state(ccfg, model=cmodel), cfeats)
    launches, _ = read_counts(torch, total)
    print(f"tdaa_crm dense step: loss {float(cmet['loss']):.6f}, launches "
          f"{launches}", flush=True)
    if not np.isfinite(float(cmet["loss"])):
        fail(f"tdaa_crm dense step loss {cmet['loss']}")
    expect_counts("tdaa_crm dense step", launches,
                  {"lstm_fwd": layers, "lstm_bwd": layers})

    # tdaa_recursive: one two-step peel of a request
    rcfg = preset("tdaa_recursive")
    rmodel = init_separator(rcfg, torch.Generator().manual_seed(SEED), dev)
    zero_counts(torch)
    rec, rspk = recursive_waveforms(rmodel, w1, rcfg, length=N_SAMPLES)
    launches, bodies = read_counts(torch, total)
    steps = rcfg.recursive_max_steps
    print(f"tdaa_recursive: speakers {rspk.tolist()}, launches {launches}, "
          f"bodies {bodies}", flush=True)
    expect_counts("tdaa_recursive peel", launches,
                  {"stft_features": 1, "lstm_fwd": steps * (layers + clayers)})
    ref, ref_spk = recursive_waveforms(rmodel, w1, rcfg.replace(**flags_off),
                                       length=N_SAMPLES)
    if not torch.equal(rspk, ref_spk):
        fail(f"tdaa_recursive peeled {rspk.tolist()}, the plain path "
             f"{ref_spk.tolist()}")
    compare("tdaa_recursive two-step peel", rec, ref)

    return total


def learning_phase(torch, tmp, steps=LEARN_STEPS):
    """11. The learning check: run.train --preset torch_multi from scratch
    for `steps` steps in epochs of LEARN_STEPS, going on after each epoch
    with --resume, and run.evaluate's teacher-forced held-out SI-SDR of
    the checkpoint after each epoch against step 0 (the same seed's
    initial weights) on the same held-out batches. The score after the
    first epoch must gain TOL["learning_gain_db"] over step 0."""
    from dl4ss_tpu_torch.run import evaluate as evaluate_cli
    from dl4ss_tpu_torch.run import train as train_cli
    ck = os.path.join(tmp, "learn")
    common = ["--preset", "torch_multi", "--seed", str(SEED), "--device",
              "cuda"]
    score = ["--teacher-forced", "--batches", str(LEARN_BATCHES)]
    before, _ = quiet(evaluate_cli.main, [*common, *score])
    print(f"learning: held-out teacher-forced SI-SDR {before:.3f} dB at "
          f"step 0 ({LEARN_BATCHES} batches)", flush=True)
    first = None
    for epoch in range(1, steps // LEARN_STEPS + 1):
        quiet(train_cli.main, [*common, "--epochs", str(epoch),
                               "--epoch-size", str(LEARN_STEPS),
                               "--eval-every", "0", "--checkpoint-dir", ck,
                               *(["--resume"] if epoch > 1 else [])])
        after, _ = quiet(evaluate_cli.main, [*common, *score,
                                             "--checkpoint-dir", ck])
        first = after if first is None else first
        print(f"learning: {after:.3f} dB after {epoch * LEARN_STEPS} "
              f"B={BATCH} steps, gain {after - before:.3f} dB", flush=True)
    gain = first - before
    print(f"learning: gain {gain:.3f} dB after {LEARN_STEPS} steps (at "
          f"least {TOL['learning_gain_db']} required)", flush=True)
    if not gain >= TOL["learning_gain_db"]:
        fail(f"the port did not learn: {before} -> {first} dB")


def learning_curve(torch, steps: int) -> int:
    """`chip_smoke.py --learning STEPS`: the learning check alone, scored
    every LEARN_STEPS steps up to `steps`, then the card's line."""
    if steps < LEARN_STEPS or steps % LEARN_STEPS:
        print(f"chip_smoke: --learning takes a multiple of {LEARN_STEPS}",
              file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        learning_phase(torch, tmp, steps)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


def _head_lists(src, dst, n):
    """Copy every list of `src` to `dst`, cut to its first `n` entries."""
    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(src)):
        with open(os.path.join(src, name)) as fh:
            lines = fh.read().splitlines()[:n]
        with open(os.path.join(dst, name), "w") as fh:
            fh.write("\n".join(lines) + "\n")


def _per_step(launches, steps, names):
    """Launches of `names` per step; fails unless each divides evenly."""
    out = {}
    for n in names:
        count = launches.get(n, 0)
        if count % steps:
            fail(f"{count} launches of {n} over {steps} steps")
        out[n] = count // steps
    return out


def data_phase(torch, dev, tmp, size):
    """12. Data sources and scoring at full width on a rehearsal corpus
    that the port's generate_corpus writes: 101 speakers, 5 s at 8 kHz,
    +/-2.5 dB gains, k = 1, 2 and 3 lists, `size` setting the depth
    (utterances a speaker and list entries). The native loader against
    the plain one; a list batch mixed on the card against the CPU's; the
    device prefetch against synchronous copies; run.train from the speaker
    tree (torch_multi joint, torch_multi_noise with a noise directory,
    tdaa adversarial), from the lists (tdaa adversarial with dis-sp, a
    resumed run against an unbroken one, torch_multi_3db on k = 1, 2, 3)
    and run.classify from the lists, each list-driven step launching what
    its bank-driven counterpart launches; BSS-Eval on the card against the
    float64 oracle, and its time a batch; run.evaluate --list-dir
    --bss-eval --oracle irm --export-wavs from the tdaa checkpoint, and
    run.score reproducing its SDR. Returns the launches by kernel of the
    CLI runs."""
    from dl4ss_tpu_torch import native, preset
    from dl4ss_tpu_torch.data.dirtree import (StreamingTreeSampler,
                                              _load_fixed)
    from dl4ss_tpu_torch.data.listsampler import Wsj0MixSampler, mix_from_list
    from dl4ss_tpu_torch.data.loader import device_prefetch, to_pinned
    from dl4ss_tpu_torch.data.rehearsal import generate_corpus
    from dl4ss_tpu_torch.data.synth import featurize
    from dl4ss_tpu_torch.data.wavio import write_wav
    from dl4ss_tpu_torch.eval.bss_eval import (bss_eval_sources,
                                               bss_eval_sources_numpy)
    from dl4ss_tpu_torch.run import classify as classify_cli
    from dl4ss_tpu_torch.run import evaluate as evaluate_cli
    from dl4ss_tpu_torch.run import score as score_cli
    from dl4ss_tpu_torch.run import train as train_cli
    from dl4ss_tpu_torch.train.steps import make_eval_step
    total = collections.Counter()
    root = os.path.join(tmp, "corpus")
    t0 = time.perf_counter()
    stats = generate_corpus(root, n_spk=101, utts=size["utts"],
                            seconds=N_SAMPLES / 8000,
                            tr_entries=size["tr"], cv_entries=size["cv"],
                            tt_entries=size["tt"], mix_ks=(1, 2, 3),
                            cv_holdout=size["holdout"])
    print(f"data: rehearsal corpus {stats['speakers']} speakers x "
          f"{size['utts']} utterances ({size['holdout']} held out), lists "
          f"{size['tr']} / {size['cv']} / {size['tt']} entries for k = 1, 2, "
          f"3, written in {time.perf_counter() - t0:.1f} s", flush=True)
    lists, head = os.path.join(root, "lists"), os.path.join(tmp, "head")
    _head_lists(lists, head, DATA_HEAD)
    tree = os.path.join(root, "wsj0")
    noise = os.path.join(tmp, "noise")
    os.makedirs(noise)
    nrng = np.random.default_rng(SEED)
    for i in range(6):     # brown noise: integrated white noise, 5 s
        w = np.cumsum(nrng.standard_normal(N_SAMPLES))
        w = w - np.linspace(w[0], w[-1], N_SAMPLES)
        write_wav(os.path.join(noise, f"street{i}.wav"),
                  0.5 * w / np.abs(w).max(), 8000)

    # ---- the loader: native against plain, decode rates ----------------
    cfg = preset("torch_multi")
    paths = sorted(os.path.join(d, f) for d, _, fs in os.walk(tree)
                   for f in fs if f.endswith(".wav"))
    t0 = time.perf_counter()
    native.library()                   # the g++ build, outside the timing
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    bank_n = native.load_batch(paths, cfg.frame_rate, cfg.max_len,
                               normalize=True)
    native_s = time.perf_counter() - t0
    sub = paths[::max(1, len(paths) // DATA_PLAIN_UTTS)][:DATA_PLAIN_UTTS]
    t0 = time.perf_counter()
    bank_p = np.stack([_load_fixed(p, cfg.frame_rate, cfg.max_len, True)
                       for p in sub])
    plain_s = time.perf_counter() - t0
    err = float(np.abs(bank_n[[paths.index(p) for p in sub]]
                       - bank_p).max())
    print(f"data: native loader built in {build_s:.2f} s; decode "
          f"{len(paths)} utterances native in {native_s:.2f} s "
          f"({len(paths) / native_s:.1f} utterances/s); plain "
          f"{len(sub) / plain_s:.1f} utterances/s ({len(sub)} utterances)",
          flush=True)
    check("native loader vs plain, normalized utterances", err,
          TOL["loader"])
    del bank_n

    # ---- a list batch on the card against the CPU's ---------------------
    tcfg = preset("tdaa")
    t0 = time.perf_counter()
    sampler = Wsj0MixSampler(lists, root, tcfg, "train", device=dev)
    load_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    dbank = sampler.device_bank()
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    bank_bytes = dbank.numel() * dbank.element_size()
    print(f"data: train sampler {len(sampler.utt2row)} unique utterances "
          f"decoded in {load_s:.2f} s, bank {bank_bytes} bytes on the "
          f"device ({bank_bytes / 2**30:.3f} GiB, upload {upload_s:.3f} s), "
          f"{sampler.num_batches(BATCH)} B={BATCH} batches an epoch",
          flush=True)
    cpu_bank = torch.as_tensor(sampler.bank)
    errs = []
    for i, (utt, db, spk, live) in enumerate(sampler.epoch(BATCH, seed=1)):
        if i == 2:
            break
        on_card = sampler.to_batch(utt, db, spk, live)
        on_cpu = mix_from_list(cpu_bank, torch.as_tensor(utt).long(),
                               torch.as_tensor(db), torch.as_tensor(spk),
                               tcfg, live=torch.as_tensor(live))
        errs += [max_err(on_card.mix_wav.cpu(), on_cpu.mix_wav),
                 max_err(on_card.source_wavs.cpu(), on_cpu.source_wavs)]
    check("list batch on the card vs the CPU", max(errs), TOL["list_batch"])
    del cpu_bank

    # ---- the device prefetch ----------------------------------------------
    streamer = StreamingTreeSampler(tree, cfg, "si_tr_s", seed=SEED + 3)
    batches = list(streamer.batches(BATCH, DATA_PREFETCH))
    pinned = all(t.is_pinned() for t in to_pinned(batches[0]).values())
    sync = [{k: torch.as_tensor(v).to(dev) for k, v in b.items()}
            for b in batches]
    got = list(device_prefetch(iter(batches), depth=2, device=dev))
    torch.cuda.synchronize()
    equal = all(torch.equal(a[k], b[k]) for a, b in zip(got, sync)
                for k in a)
    print(f"data: prefetch of {len(batches)} streamed B={BATCH} batches "
          f"bit-equal to synchronous copies {equal}, host buffers pinned "
          f"{pinned}", flush=True)
    if not (equal and pinned):
        fail("device_prefetch differs from synchronous copies or its host "
             "buffers are not pinned")
    del batches, sync, got

    # ---- the training runs -------------------------------------------------
    joint_k = ("stft_features", "gru_fwd", "gru_bwd", "maskhead_fwd",
               "maskhead_bwd")
    adv_k = ("stft_features", "lstm_fwd", "lstm_bwd", "maskhead_fwd",
             "maskhead_bwd")
    base = ["--seed", str(SEED), "--device", "cuda", "--eval-every", "0"]
    tree_args = ["--data-root", tree, "--split", "si_tr_s", "--utts",
                 str(size["utts"] - size["holdout"]), "--epochs", "1",
                 "--epoch-size", str(DATA_TREE_STEPS)]
    ck = os.path.join(tmp, "data_ck")
    head_steps = {k: DATA_HEAD // cfg.batch_size for k in (1, 2, 3)}
    runs = (
        ("torch_multi joint, tree", ["--preset", "torch_multi", *tree_args],
         DATA_TREE_STEPS, joint_k),
        ("torch_multi_noise joint, tree + noise",
         ["--preset", "torch_multi_noise", *tree_args, "--noise-wavs",
          noise], DATA_TREE_STEPS, joint_k),
        ("tdaa adversarial dis-sp, tree",
         ["--preset", "tdaa", "--mode", "adversarial", "--dis-sp",
          *tree_args], DATA_TREE_STEPS, adv_k),
        ("tdaa adversarial dis-sp, lists",
         ["--preset", "tdaa", "--mode", "adversarial", "--dis-sp",
          "--list-dir", lists, "--wav-root", root, "--epochs", "1",
          "--checkpoint-dir", ck], size["tr"] // tcfg.batch_size, adv_k),
        ("torch_multi_3db joint, lists k=1,2,3",
         ["--preset", "torch_multi_3db", "--list-dir", head, "--wav-root",
          root, "--mix-k", "1,2,3", "--epochs", "1"],
         sum(head_steps.values()), joint_k),
    )
    per_step = {}
    for label, argv, steps, names in runs:
        zero_counts(torch)
        state, _ = quiet(train_cli.main, [*argv, *base])
        launches, bodies = read_counts(torch, total)
        if state.step != steps:
            fail(f"run.train {label}: {state.step} steps, expected {steps}")
        per_step[label] = _per_step(launches, steps, names)
        print(f"data: run.train {label}: {steps} steps, launches a step "
              f"{per_step[label]}, bodies {bodies}", flush=True)
        if label.startswith("tdaa adversarial dis-sp, lists"):
            tdaa_state = state
    for bank_label, list_label, want in (
            ("torch_multi joint, tree", "torch_multi_3db joint, lists "
             "k=1,2,3", {"stft_features": 2, "gru_fwd": 2, "gru_bwd": 2,
                         "maskhead_fwd": 1, "maskhead_bwd": 1}),
            ("tdaa adversarial dis-sp, tree",
             "tdaa adversarial dis-sp, lists",
             {"stft_features": 2, "lstm_fwd": 8, "lstm_bwd": 4,
              "maskhead_fwd": 2, "maskhead_bwd": 1})):
        for label in (bank_label, list_label):
            expect_counts(f"run.train {label}, a step", per_step[label],
                          want)
    if per_step["torch_multi_noise joint, tree + noise"] != per_step[
            "torch_multi joint, tree"]:
        fail("the noise run launched other kernels than the joint one")

    # run.classify from the lists: K1 2, K7 2 and K8 2 a step, K1 2 and K7 2
    # a report batch
    zero_counts(torch)
    report, text = quiet(classify_cli.main, [
        "--preset", "torch_multi", "--list-dir", head, "--wav-root", root,
        "--epochs", "1", "--eval-batches", "2", "--seed", str(SEED),
        "--device", "cuda"])
    launches, _ = read_counts(torch, total)
    csteps = head_steps[2]
    want = {"stft_features": 2 * (csteps + 2), "lstm_fwd": 2 * (csteps + 2),
            "lstm_bwd": 2 * csteps}
    print(f"data: run.classify --list-dir: {csteps} steps, launches "
          f"{launches}; top3_recall {report['top3_recall']:.4f}",
          flush=True)
    expect_counts("run.classify --list-dir", launches, want)

    # ---- resume from the lists ---------------------------------------------
    resume = ["--preset", "torch_multi", "--list-dir", head, "--wav-root",
              root, "--set", "augment_data=1", "--seed", str(SEED),
              "--device", "cuda", "--eval-every", "0"]
    rck = os.path.join(tmp, "data_resume")
    quiet(train_cli.main, [*resume, "--epochs", "1", "--checkpoint-dir",
                           rck])
    resumed, text = quiet(train_cli.main, [*resume, "--epochs", "2",
                                           "--checkpoint-dir", rck,
                                           "--resume"])
    unbroken, _ = quiet(train_cli.main, [*resume, "--epochs", "2"])
    pairs = list(zip(resumed.model.state_dict().values(),
                     unbroken.model.state_dict().values()))
    pairs += list(zip(resumed.opt_state.mu + resumed.opt_state.nu,
                      unbroken.opt_state.mu + unbroken.opt_state.nu))
    worst = max(rel_l2(a, b) for a, b in pairs)
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    print(f"data: list-driven resume (1 epoch + --resume 1 against 2 "
          f"unbroken epochs of {head_steps[2]} steps, shift augment on): "
          f"steps {resumed.step} and {unbroken.step}, {len(pairs)} tensors, "
          f"worst rel L2 {worst:.3e}, bit-equal {bit_equal}", flush=True)
    if (resumed.step != unbroken.step or "resuming" not in text
            or not worst <= TOL["repeat_rel"]):
        fail(f"the resumed list-driven run differs from the unbroken one: "
             f"{worst}")

    # ---- BSS-Eval on the card against the float64 oracle -------------------
    tt = Wsj0MixSampler(lists, root, tcfg, "test",
                        spk2idx=sampler.spk2idx, device=dev)
    batch = next(tt.batches(BATCH, shuffle=False))
    ev = make_eval_step(tcfg.replace(num_speakers=sampler.num_speakers,
                                     use_discriminator=True))
    out = ev(tdaa_state.model, featurize(batch, tcfg))
    ref, est = batch.source_wavs.float(), out["pred_wavs"].float()
    res = bss_eval_sources(ref, est)
    bss_ms = device_ms(torch, lambda: bss_eval_sources(ref, est), 3)
    worst, perms_ok = 0.0, True
    for i in range(DATA_BSS_ORACLE):
        sdr, sir, sar, perm = bss_eval_sources_numpy(
            ref[i].double().cpu().numpy(), est[i].double().cpu().numpy())
        perms_ok &= bool((res.perm[i].cpu().numpy() == perm).all())
        for got, want_ in ((res.sdr, sdr), (res.sir, sir), (res.sar, sar)):
            worst = max(worst, float(np.abs(got[i].cpu().numpy()
                                            - want_).max()))
    print(f"data: BSS-Eval flen=512 on the card {bss_ms:.3f} ms per "
          f"B={BATCH} batch (K=2, N={N_SAMPLES}, CUDA events); against the "
          f"float64 oracle on {DATA_BSS_ORACLE} mixtures: worst "
          f"{worst:.3e} dB over SDR / SIR / SAR, permutations equal "
          f"{perms_ok}; mean SDR {float(res.sdr.mean()):.3f} dB", flush=True)
    if not (perms_ok and worst <= TOL["bss_db"]):
        fail(f"BSS-Eval on the card: worst {worst} dB, permutations equal "
             f"{perms_ok}")

    # ---- run.evaluate --list-dir, then run.score ---------------------------
    export = os.path.join(tmp, "data_export")
    zero_counts(torch)
    _, text = quiet(evaluate_cli.main, [
        "--preset", "tdaa", "--checkpoint-dir", ck, "--list-dir", lists,
        "--wav-root", root, "--split", "test", "--teacher-forced",
        "--bss-eval", "--oracle", "irm", "--export-wavs", export,
        "--device", "cuda"])
    launches, _ = read_counts(torch, total)
    line = next(x for x in text.splitlines() if x.startswith("BSS-Eval SDR"))
    eval_sdr = float(line.split()[2])
    n_eval = size["tt"] // tcfg.batch_size_eval
    print("data: run.evaluate --list-dir --split test: "
          + "; ".join(x for x in text.splitlines()
                      if x.startswith(("SI-SDR", "oracle", "BSS-Eval")))
          + f"; launches {launches}", flush=True)
    expect_counts("run.evaluate --list-dir", launches, {
        "stft_features": 2 * n_eval, "lstm_fwd": 4 * n_eval,
        "maskhead_fwd": n_eval})
    scored, _ = quiet(score_cli.main, [export, "--nsdr", "--device",
                                       "cuda"])
    gap = abs(scored["mean_sdr"] - eval_sdr)
    print(f"data: run.score --nsdr: {scored['n_mixtures']} mixtures, SDR "
          f"{scored['mean_sdr']:.4f} dB (run.evaluate {eval_sdr:.4f}, gap "
          f"{gap:.4f} dB), NSDR {scored['mean_nsdr']:.4f} dB", flush=True)
    if scored["n_mixtures"] != size["tt"] or not gap <= TOL["score_db"]:
        fail(f"run.score: {scored['n_mixtures']} mixtures, SDR gap {gap} dB")
    return total


def generations_phase(torch, dev, tmp):
    """13. The Cocktail memory, image-query and video generations at full
    width. `cocktail` in memory mode on a rehearsal corpus that
    generate_corpus writes (GEN_SPEAKERS speakers, 5 s) and on the Cocktail
    wavlists over it: run.train saves one epoch of GEN_RESUME_STEPS steps,
    --resume adds a second, which must improve the dev loss (the loop then
    ends on it, so the resumed run and an unbroken one must agree in
    parameters, memory rows and ages, moments, step and generator);
    run.train --file-lists; run.evaluate --mode memory on known speakers,
    --unk-holdout, --unk-root (a second corpus) and the wavlists' test and
    unk splits. `multimodal_image` (two image-query steps on the glyphs),
    `grid_video` (the conv trunk on 48x48 synthetic lips, then one step
    with the frozen Inception trunk at 299x299, whose parameters must not
    move). One step of each path with the counts zeroed just before and
    read just after, held to the launches its flags send (K1 2, K7 / K8 4
    each for a cocktail memory step; K1 2, K2 / K5 2 each, K3 / K6 1 each
    with one W pack, and K7 / K8 2 each for a grid_video step; none for
    multimodal_image and cocktail_debug); the query BiLSTMs on K7 / K8
    against their plain loop on the card; one memory and one video-query
    step on the card against the CPU; the two learning gates. Returns the
    launches by kernel of the CLI runs."""
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.data.dirtree import DirTreeSampler
    from dl4ss_tpu_torch.data.layout_tools import generate_file_lists
    from dl4ss_tpu_torch.data.mnist import digit_query_bank, load_mnist
    from dl4ss_tpu_torch.data.rehearsal import (cocktail_layout,
                                                generate_corpus)
    from dl4ss_tpu_torch.data.synth import make_synthetic_bank
    from dl4ss_tpu_torch.data.video import synthetic_frame_bank
    from dl4ss_tpu_torch.models.query import (apply_speech_query,
                                              apply_video_query)
    from dl4ss_tpu_torch.run import evaluate as evaluate_cli
    from dl4ss_tpu_torch.run import train as train_cli
    from dl4ss_tpu_torch.train.memory_trainer import (_valid_frames,
                                                      create_memory_state,
                                                      make_memory_eval_step,
                                                      make_memory_train_step,
                                                      memory_batch)
    from dl4ss_tpu_torch.train.query_trainer import (create_query_state,
                                                     make_query_eval_step,
                                                     make_query_train_step,
                                                     query_batch)
    from dl4ss_tpu_torch.weights import export_jax_params, flatten_tree
    total = collections.Counter()

    def leaves(m):
        return dict(flatten_tree(export_jax_params(m)))

    def dev_losses(path):
        with open(path) as fh:
            return [json.loads(line)["dev_loss"] for line in fh
                    if '"dev_loss"' in line]

    # ---- the corpora and the Cocktail wavlists ---------------------------
    root = os.path.join(tmp, "gen")
    t0 = time.perf_counter()
    for name, n_spk, utts, seed in (("a", GEN_SPEAKERS, GEN_UTTS, 1),
                                    ("b", 4, 3, 7)):
        generate_corpus(os.path.join(root, name), n_spk=n_spk, utts=utts,
                        seconds=N_SAMPLES / 8000, tr_entries=16,
                        cv_entries=4, tt_entries=4, seed=seed,
                        cv_holdout=1)
    cocktail_layout(os.path.join(root, "a"), os.path.join(root, "ct"), 2,
                    os.path.join(root, "b"))
    lists = os.path.join(root, "lists")
    generate_file_lists(os.path.join(root, "ct"), lists)
    print(f"generations: corpora of {GEN_SPEAKERS} x {GEN_UTTS} and 4 x 3 "
          f"utterances, Cocktail wavlists ({time.perf_counter() - t0:.1f} s)",
          flush=True)

    # ---- cocktail, memory mode: save, resume, wavlists, evaluation --------
    tree = ["--data-root", os.path.join(root, "a", "wsj0"), "--split",
            "si_tr_s", "--utts", str(GEN_UTTS - 2)]
    mem = ["--preset", "cocktail", "--mode", "memory", "--seed", str(SEED),
           "--device", "cuda", "--epoch-size", str(GEN_RESUME_STEPS), *tree]
    ck = os.path.join(tmp, "gen_ck")
    m_res, m_unb = (os.path.join(tmp, f"gen_{n}.jsonl") for n in "ru")
    zero_counts(torch)
    quiet(train_cli.main, [*mem, "--epochs", "1", "--checkpoint-dir", ck,
                           "--metrics", m_res])
    resumed, text = quiet(train_cli.main, [*mem, "--epochs", "2",
                                           "--checkpoint-dir", ck,
                                           "--resume", "--metrics", m_res])
    unbroken, _ = quiet(train_cli.main, [*mem, "--epochs", "2",
                                         "--metrics", m_unb])
    launches, _ = read_counts(torch, total)
    if "resumed memory-mode step" not in text:
        fail("run.train --mode memory --resume did not restore the "
             "checkpoint")
    hist, hist_r = dev_losses(m_unb), dev_losses(m_res)
    # the loop ends on its best epoch's parameters and memory with the last
    # step's moments, and the checkpoint holds that state, as JAX's does:
    # a resumed run restarts from the best state. The resumed run's best is
    # its one epoch, the second; the unbroken run ends on the second only
    # if it improved on the first, which this check requires
    improved = len(hist) == 2 and hist[1] < hist[0]
    same = list(zip(resumed.opt_state.mu + resumed.opt_state.nu,
                    unbroken.opt_state.mu + unbroken.opt_state.nu))
    same += list(zip([*resumed.model.state_dict().values(),
                      *resumed.memory],
                     [*unbroken.model.state_dict().values(),
                      *unbroken.memory]))
    bit_equal = (all(torch.equal(a, b) for a, b in same)
                 and hist_r == hist and resumed.step == unbroken.step
                 and torch.equal(resumed.generator.get_state(),
                                 unbroken.generator.get_state()))
    print(f"cocktail memory resume: 1 epoch + --resume 1 against 2 unbroken "
          f"epochs of {GEN_RESUME_STEPS} steps; dev losses "
          f"unbroken {hist}, resumed {hist_r}; the second epoch improved "
          f"{improved}; step {resumed.step} and {unbroken.step}; "
          f"{len(same)} tensors (moments, parameters, memory rows and "
          f"ages), the step and the batch generator bit-equal {bit_equal}; "
          f"launches {launches}", flush=True)
    if not improved:
        fail(f"cocktail memory resume: the second epoch did not improve the "
             f"dev loss ({hist})")
    if not bit_equal:
        fail("cocktail memory: the resumed run is not bit-equal to the "
             "unbroken one")
    del resumed, unbroken

    ckl = os.path.join(tmp, "gen_ckl")
    zero_counts(torch)
    quiet(train_cli.main, ["--preset", "cocktail", "--mode", "memory",
                           "--seed", str(SEED), "--device", "cuda",
                           "--file-lists", lists, "--epochs", "1",
                           "--epoch-size", str(GEN_STEPS),
                           "--checkpoint-dir", ckl])
    launches, _ = read_counts(torch, total)
    with open(os.path.join(ckl, "vocab.json")) as fh:
        vocab = json.load(fh)
    print(f"cocktail memory --file-lists: {len(vocab)} speakers in "
          f"vocab.json; launches {launches}", flush=True)
    if len(vocab) != GEN_SPEAKERS:
        fail(f"run.train --file-lists wrote a vocabulary of {len(vocab)}")
    evals = (("known speakers", ck, [*tree, "--batches", "2"]),
             ("--unk-holdout 2", ck, [*tree, "--unk-holdout", "2"]),
             ("--unk-root", ck, [*tree, "--unk-root",
                                 os.path.join(root, "b", "wsj0")]),
             ("wavlist test", ckl, ["--file-lists", lists, "--split",
                                    "test"]),
             ("wavlist unk", ckl, ["--file-lists", lists, "--split",
                                   "unk"]))
    for label, ckd, extra in evals:
        zero_counts(torch)
        res, text = quiet(evaluate_cli.main, [
            "--mode", "memory", "--checkpoint-dir", ckd, "--seed",
            str(SEED), "--device", "cuda", *extra])
        launches, _ = read_counts(torch, total)
        lines = [ln for ln in text.splitlines() if "SI-SDR" in ln]
        print(f"run.evaluate --mode memory {label}: {lines[-1:]}; launches "
              f"{launches}", flush=True)
        if not np.isfinite([res["si_sdr"], res["nsdr"],
                            *res["gain"].values()]).all():
            fail(f"run.evaluate --mode memory {label}: {res}")

    # ---- one step of each path: its launches ------------------------------
    cfg_m = preset("cocktail")
    bank = torch.as_tensor(make_synthetic_bank(
        SEED, cfg_m.num_speakers, BANK_UTTS, N_SAMPLES), device=dev)
    gen = torch.Generator().manual_seed(SEED)
    mstate = create_memory_state(cfg_m, SEED, device=dev)
    mstep = make_memory_train_step(cfg_m)
    # a step draws its batch: K1 runs in featurize
    zero_counts(torch)
    mfeats = memory_batch(gen, bank, cfg_m)
    mstep(mstate, mfeats)
    launches, bodies = read_counts(torch)
    print(f"cocktail memory step: launches {launches}, bodies {bodies}",
          flush=True)
    expect_counts("cocktail memory step", launches, {
        "stft_features": 2, "lstm_fwd": 4, "lstm_bwd": 4, "gru_fwd": 0,
        "gru_bwd": 0, "maskhead_pack": 0, "maskhead_fwd": 0,
        "maskhead_bwd": 0, "masked_istft": 0})

    cfg_v = preset("grid_video")
    frames = torch.as_tensor(synthetic_frame_bank(
        cfg_v.num_speakers, 2, 4, (48, 48), seed=SEED), device=dev)
    vstate = create_query_state(cfg_v, SEED, device=dev)
    vstep = make_query_train_step(cfg_v)
    zero_counts(torch)
    vfeats = query_batch(gen, bank, cfg_v, "query_video", frames)
    vstep(vstate, vfeats)
    launches, bodies = read_counts(torch)
    print(f"grid_video step (conv trunk): launches {launches}, bodies "
          f"{bodies}", flush=True)
    expect_counts("grid_video step", launches, {
        "stft_features": 2, "gru_fwd": 2, "gru_bwd": 2, "maskhead_pack": 1,
        "maskhead_fwd": 1, "maskhead_bwd": 1, "lstm_fwd": 2, "lstm_bwd": 2,
        "masked_istft": 0})

    cfg_i = preset("multimodal_image")
    imgs, labels = load_mnist(None)
    digits = torch.as_tensor(digit_query_bank(imgs, labels,
                                              cfg_i.num_speakers),
                             device=dev)
    istate = create_query_state(cfg_i, SEED, "image", device=dev)
    istep = make_query_train_step(cfg_i, "image")
    cfg_d = preset("cocktail_debug")
    dstate = create_memory_state(cfg_d, SEED, device=dev)
    dstep = make_memory_train_step(cfg_d)
    for label, run in (
            ("multimodal_image step", lambda: istep(istate, query_batch(
                gen, bank, cfg_i, "query_image", digits))),
            ("cocktail_debug memory step", lambda: dstep(
                dstate, memory_batch(gen, bank, cfg_d)))):
        zero_counts(torch)
        run()
        launches, _ = read_counts(torch)
        print(f"{label}: launches {launches}", flush=True)
        if launches:
            fail(f"{label} launched {launches}; its flags ask for none")
    del dstate

    # run.train --mode image-query: two steps on the glyphs, no kernel
    zero_counts(torch)
    img, _ = quiet(train_cli.main, [
        "--preset", "multimodal_image", "--mode", "image-query", "--seed",
        str(SEED), "--device", "cuda", "--utts", str(BANK_UTTS),
        "--epochs", "1", "--epoch-size", "2"])
    launches, _ = read_counts(torch)
    print(f"run.train --preset multimodal_image --mode image-query: step "
          f"{img.step}; launches {launches}", flush=True)
    if img.step != 2 or launches:
        fail(f"run.train --mode image-query: step {img.step}, launches "
             f"{launches}")
    del img

    # ---- the query BiLSTMs: K7 / K8 against the plain loop on the card ----
    # JAX runs them as a lax.scan (no kernel); the port sends them through
    # K7 / K8 where the preset asks for the recurrent kernels
    clean = mfeats["clean_feas"]
    valid = _valid_frames(clean, cfg_m)
    query = mstate.model.speech_query
    vquery = vstate.model.video_query
    # (B, K, T, H, W, 3): one clip a mixture's speaker
    clips = vfeats["query_video"].flatten(0, 1)
    for label, module, run in (
            ("speech query BiLSTM-25 x 2", query,
             lambda k: apply_speech_query(query, clean, valid, k)),
            ("video query BiLSTM-300 x 2", vquery,
             lambda k: apply_video_query(vquery, clips, k)[1])):
        names = [n for n, _ in module.named_parameters()
                 if n.startswith("rnn.")]
        params = [p for n, p in module.named_parameters()
                  if n.startswith("rnn.")]
        outs, grads = {}, {}
        for kernels in (True, False):
            out = run(kernels)
            # a fixed random cotangent reaches every gradient
            cot = torch.randn(out.shape, generator=torch.Generator()
                              .manual_seed(SEED)).to(dev)
            grads[kernels] = torch.autograd.grad((out * cot).sum(), params)
            outs[kernels] = out.detach()
        err = check(f"{label} K7 vs plain loop (forward)",
                    max_err(outs[True], outs[False]), TOL["query_rnn_fwd"])
        worst = max((rel_l2(a, b), n) for n, a, b in
                    zip(names, grads[True], grads[False]))
        print(f"{label}: K7 / K8 against the plain loop on the card: output "
              f"max_abs_err {err:.3e} tol {TOL['query_rnn_fwd']:.0e}; "
              f"{len(names)} gradients, worst rel L2 {worst[0]:.3e} "
              f"({worst[1]}) tol {TOL['query_rnn_bwd']:.0e}", flush=True)
        if not worst[0] <= TOL["query_rnn_bwd"]:
            fail(f"{label}: the gradient of {worst[1]} on K8 differs from "
                 f"the plain loop's by {worst[0]}")

    # ---- the card against the CPU: one memory and one video-query step ----
    # fresh states from one seed: the weights are drawn on the CPU, so the
    # twins start equal
    for label, make, create, feats, keys, loss_tol, tol in (
            ("cocktail memory step", make_memory_train_step,
             lambda d: create_memory_state(cfg_m, SEED, device=d), mfeats,
             ("loss",), TOL["mem_step_loss"], TOL["mem_step_update"]),
            ("grid_video step", make_query_train_step,
             lambda d: create_query_state(cfg_v, SEED, device=d), vfeats,
             ("loss", "mask_loss", "query_ce"), TOL["video_step_loss"],
             TOL["video_step_update"])):
        cfg = cfg_m if label.startswith("cocktail") else cfg_v
        state, twin = create(dev), create("cpu")
        before = leaves(state.model)
        step = make(cfg)
        (_, met_g), grads_g = recorded_grads(step, state, feats)
        (_, met_c), grads_c = recorded_grads(
            step, twin, {k: v.cpu() for k, v in feats.items()})
        close_losses(label, met_g, met_c, keys, loss_tol)
        close_losses(label, met_g, met_c, ("grad_norm",), tol)
        worst = leaf_updates(label, before, leaves(state.model),
                             leaves(twin.model), tol, grads_g, grads_c)
        has_memory = getattr(state, "memory", None) is not None
        mem_err = (max_err(state.memory.vectors.cpu(), twin.memory.vectors)
                   if has_memory else 0.0)
        ages = (torch.equal(state.memory.age.cpu(), twin.memory.age)
                if has_memory else True)
        print(f"{label}: {len(grads_c)} gradients and updates, worst update "
              f"rel L2 {worst:.3e} tol {tol:.0e}; memory after the write "
              f"max_abs_err {mem_err:.3e} tol {TOL['memory']:.0e}, ages "
              f"equal {ages}", flush=True)
        if not (mem_err <= TOL["memory"] and ages):
            fail(f"{label}: the memory after the write differs by {mem_err} "
                 f"(ages equal {ages})")
        del state, twin

    del mstate, vstate, istate

    # ---- grid_video with the frozen Inception trunk at 299x299 -----------
    video = ["--preset", "grid_video", "--mode", "video", "--seed",
             str(SEED), "--device", "cuda"]
    zero_counts(torch)
    inc, _ = quiet(train_cli.main, [*video, "--video-trunk", "inception",
                                    "--epochs", "1", "--epoch-size", "1",
                                    "--eval-every", "0"])
    launches, _ = read_counts(torch, total)
    fresh = create_query_state(cfg_v, SEED, video_trunk="inception",
                               frame_hw=(299, 299), device=dev)
    trunk = [(n, p) for n, p in inc.model.named_parameters()
             if n.startswith("video_query.inception.")]
    ref = dict(fresh.model.named_parameters())
    moved = [n for n, p in trunk if not torch.equal(p, ref[n])]
    head_moved = not torch.equal(inc.model.video_query.dense.w,
                                 ref["video_query.dense.w"])
    print(f"grid_video Inception trunk: one step; {len(trunk)} trunk "
          f"parameters, {len(moved)} moved; the query head moved "
          f"{head_moved}; launches {launches}", flush=True)
    if moved or not head_moved:
        fail(f"the frozen Inception trunk moved ({moved[:3]}) or the head "
             f"did not")
    del fresh, inc

    # ---- the learning gates, on one 101 x 8 rehearsal tree ------------------
    t0 = time.perf_counter()
    generate_corpus(os.path.join(root, "c"), n_spk=LEARN_SPEAKERS,
                    utts=LEARN_UTTS, seconds=N_SAMPLES / 8000,
                    tr_entries=16, cv_entries=4, tt_entries=4,
                    seed=LEARN_TREE_SEED, cv_holdout=1)
    learn_root = os.path.join(root, "c", "wsj0")
    train_utts = LEARN_UTTS - LEARN_HELD_UTTS
    print(f"generations: learning corpus of {LEARN_SPEAKERS} x {LEARN_UTTS} "
          f"utterances, seed {LEARN_TREE_SEED} "
          f"({time.perf_counter() - t0:.1f} s)", flush=True)

    def held_bank(cfg):
        held = DirTreeSampler(learn_root, cfg, "si_tr_s", LEARN_HELD_UTTS,
                              utts_offset=train_utts)
        return (cfg.replace(num_speakers=held.num_speakers),
                torch.as_tensor(held.bank, device=dev))

    # cocktail memory mode: run.train's own dev MSE (its dev batch drawn
    # from seed + 13, as JAX's run.train draws it) at step 0 and after
    # MEM_LEARN_STEPS steps, on all LEARN_UTTS utterances a speaker
    def memory_run(utts, epochs, esize, path):
        return quiet(train_cli.main, [
            "--preset", "cocktail", "--mode", "memory", "--seed", str(SEED),
            "--device", "cuda", "--data-root", learn_root, "--split",
            "si_tr_s", "--utts", str(utts), "--epochs", str(epochs),
            "--epoch-size", str(esize), "--metrics", path])[0]

    m0, m1 = (os.path.join(tmp, f"gen_learn{i}.jsonl") for i in (0, 1))
    memory_run(LEARN_UTTS, 1, 0, m0)
    zero_counts(torch)
    memory_run(LEARN_UTTS, 10, MEM_LEARN_STEPS // 10, m1)
    read_counts(torch, total)
    start, curve = dev_losses(m0)[0], dev_losses(m1)
    ratio = curve[-1] / start
    print(f"learning cocktail memory ({LEARN_SPEAKERS}-speaker tree, "
          f"{LEARN_UTTS} utterances a speaker): dev MSE {start:.4f} at step "
          f"0, {curve} every {MEM_LEARN_STEPS // 10} steps; "
          f"after {MEM_LEARN_STEPS} steps {ratio:.4f} of step 0 (gate: at "
          f"most {TOL['memory_learn_ratio']})", flush=True)
    # printed, not gated: the same model trained on each speaker's first
    # train_utts utterances, its MSE on mixtures of the last ones
    cfg_h, hbank = held_bank(preset("cocktail"))
    score_m = make_memory_eval_step(cfg_h)

    def held_mse(state):
        return float(np.mean([float(score_m(state.model, state.memory,
                                            memory_batch(
            torch.Generator().manual_seed(10 ** 6 + i), hbank,
            cfg_h))["loss"]) for i in range(MEM_HELD_BATCHES)]))

    held0 = held_mse(create_memory_state(cfg_h, SEED, device=dev))
    m2 = os.path.join(tmp, "gen_learn2.jsonl")
    held_state = memory_run(train_utts, 10, MEM_LEARN_STEPS // 10, m2)
    held1 = held_mse(held_state)
    del held_state
    print(f"learning cocktail memory, printed and not gated: trained on "
          f"{train_utts} utterances a speaker, MSE on {MEM_HELD_BATCHES} "
          f"batches of mixtures of the last {LEARN_HELD_UTTS}: {held0:.4f} "
          f"at step 0, {held1:.4f} after {MEM_LEARN_STEPS} steps "
          f"({held1 / held0:.4f}); its run.train dev MSE {dev_losses(m2)}",
          flush=True)
    if not ratio <= TOL["memory_learn_ratio"]:
        fail(f"cocktail memory did not learn: dev MSE {start} -> "
             f"{curve[-1]}")

    # grid_video learns on the protocol of tools/grid_video_jax_curve.py,
    # JAX's reference: run.train from each seed on each speaker's first
    # utterances, scored before and after on mixtures of the utterances it
    # never trained on
    cfg_l, hbank = held_bank(preset("grid_video").replace(encoder_layers=1))
    score = make_query_eval_step(cfg_l)

    def held_out(state, seed):
        # the lips of the run's seed, as run.train draws them
        lips = torch.as_tensor(synthetic_frame_bank(
            cfg_l.num_speakers, 2, 4, (48, 48), seed=seed), device=dev)
        return float(np.mean([float(score(state.model, query_batch(
            torch.Generator().manual_seed(10 ** 6 + 1000 * seed + i), hbank,
            cfg_l, "query_video", lips))["si_sdr"].mean())
            for i in range(VIDEO_HELD_BATCHES)]))

    curves, ces = {}, {}
    zero_counts(torch)
    for seed in VIDEO_LEARN_SEEDS:
        m3 = os.path.join(tmp, f"gen_v{seed}.jsonl")
        start = held_out(create_query_state(cfg_l, seed, device=dev), seed)
        state, _ = quiet(train_cli.main, [
            "--preset", "grid_video", "--mode", "video", "--seed", str(seed),
            "--device", "cuda", "--data-root", learn_root, "--split",
            "si_tr_s", "--utts", str(train_utts), "--set", "encoder_layers=1",
            "--epochs", "5", "--epoch-size", str(VIDEO_LEARN_STEPS // 5),
            "--eval-every", "0", "--metrics", m3])
        curves[seed] = (round(start, 6), round(held_out(state, seed), 6))
        with open(m3) as fh:
            ces[seed] = round(json.loads(fh.readlines()[-1])["query_ce"], 3)
    read_counts(torch, total)
    gains = [end - start for start, end in curves.values()]
    gain = float(np.mean(gains))
    print(f"learning grid_video (encoder depth 1, {cfg_l.num_speakers}-"
          f"speaker tree, {train_utts} utterances a speaker, conv trunk, "
          f"48x48 synthetic lips): held-out SI-SDR (step 0, step "
          f"{VIDEO_LEARN_STEPS}) by seed {curves} dB on "
          f"{VIDEO_HELD_BATCHES} batches of the last {LEARN_HELD_UTTS} "
          f"utterances; the query CE {ces}; gains "
          f"{[round(g, 4) for g in gains]}, mean {gain:.4f} dB (gate: at "
          f"least {TOL['video_learn_db']})", flush=True)
    if not gain >= TOL["video_learn_db"]:
        fail(f"grid_video did not learn: held-out {curves}")

    return total


def rehearsal(torch) -> int:
    """`chip_smoke.py --rehearsal`: phase 12 alone at the official depth
    (REHEARSAL_DATA), then the card's line."""
    from dl4ss_tpu_torch import resolve_device
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        data_phase(torch, dev, tmp, REHEARSAL_DATA)
    print(f"rehearsal: {time.perf_counter() - t0:.1f} s", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


def generations(torch) -> int:
    """`chip_smoke.py --generations`: the kernels' build and phase 13 alone,
    then the card's line."""
    from dl4ss_tpu_torch import resolve_device
    from dl4ss_tpu_torch.ops import cuda_lib
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    cuda_lib.library()
    with tempfile.TemporaryDirectory() as tmp:
        print(f"generations: launches of the CLI runs "
              f"{dict(generations_phase(torch, dev, tmp))}", flush=True)
    print(f"generations: {time.perf_counter() - t0:.1f} s", flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


def _leaves(model):
    return {n: p.detach().float().cpu().numpy().copy()
            for n, p in model.named_parameters()}


def par_case(torch, dev, name, mesh, speakers=None, batch=None):
    """Phase 14's two steps from SEED, the same on one rank (mesh None) and
    on each rank of a mesh: (state, run), run(state) -> (state, metrics);
    `speakers` replaces the preset's speaker count, `batch` its global
    batch. "joint": torch_multi's fused step, which draws the global
    B=16 batch from the state's generator and trains on this rank's rows.
    "memory": a cocktail memory batch (drawn, featurized and then split,
    as memory_train_loop does) whose first target speaker is also the
    target of the first item of the second half, so that the two ranks
    write one memory row; the memory starts from random unit rows."""
    from dl4ss_tpu_torch import preset
    from dl4ss_tpu_torch.data.synth import make_synthetic_bank
    from dl4ss_tpu_torch.models.memory import MemorySlots
    from dl4ss_tpu_torch.parallel.mesh import shard_batch
    from dl4ss_tpu_torch.train.memory_trainer import (create_memory_state,
                                                      make_memory_train_step,
                                                      memory_batch)
    from dl4ss_tpu_torch.train.state import create_train_state
    from dl4ss_tpu_torch.train.steps import make_fused_step
    cfg = preset("torch_multi" if name == "joint" else "cocktail")
    if speakers is not None:
        cfg = cfg.replace(num_speakers=speakers)
    if batch is not None:
        cfg = cfg.replace(batch_size=batch)
    bank = torch.as_tensor(make_synthetic_bank(
        SEED, cfg.num_speakers, BANK_UTTS, N_SAMPLES), device=dev)
    if name == "joint":
        fused = make_fused_step(cfg, mesh=mesh)
        return (create_train_state(cfg, SEED, device=dev),
                lambda state: fused(state, bank))
    state = create_memory_state(cfg, SEED, device=dev)
    rows = torch.randn(state.memory.vectors.shape,
                       generator=torch.Generator().manual_seed(SEED))
    state.memory = MemorySlots(
        (rows / rows.norm(dim=-1, keepdim=True)).to(dev), state.memory.age)
    step = make_memory_train_step(cfg, mesh=mesh)

    def run(state):
        feats = memory_batch(state.generator, bank, cfg)
        spk = feats["spk_id"].clone()
        spk[BATCH // 2] = spk[0]
        feats["spk_id"] = spk
        return step(state, shard_batch(feats, mesh))

    return state, run


def par_record(torch, state, run):
    """One step of `run` with the counts zeroed just before and read just
    after: (metrics, recorded gradients, parameters, memory, launches)."""
    zero_counts(torch)
    (state, met), grads = recorded_grads(lambda s, _: run(s), state, None)
    launches, _ = read_counts(torch)
    memory = getattr(state, "memory", None)
    if memory is not None:
        memory = (memory.vectors.cpu(), memory.age.cpu())
    return ({k: float(v) for k, v in met.items()}, grads,
            _leaves(state.model), memory, launches)


# the launches of one step of par_case, on every rank
PAR_LAUNCHES = {
    "joint": {"stft_features": 2, "gru_fwd": 2, "gru_bwd": 2,
              "maskhead_fwd": 1, "maskhead_pack": 1, "maskhead_bwd": 1,
              "lstm_fwd": 0, "lstm_bwd": 0, "masked_istft": 0},
    "memory": {"stft_features": 2, "lstm_fwd": 4, "lstm_bwd": 4,
               "gru_fwd": 0, "gru_bwd": 0, "maskhead_fwd": 0,
               "masked_istft": 0}}
# the gates of a par_case step on a mesh against one rank (TOL keys)
PAR_GATES = {"joint": ("par_joint_loss", "par_joint_update"),
             "memory": ("par_mem_loss", "par_mem_update")}


def hold_to_one_rank(torch, label, refs, res):
    """Each step of `res` (rank 0's par_record by step name, every rank's
    launches) against the one-rank step of `refs` (parameters before, then
    par_record) at PAR_GATES; every rank must launch PAR_LAUNCHES. Returns
    the launches of every rank, summed."""
    total = collections.Counter()
    for name in res["steps"]:
        loss_tol, update_tol = PAR_GATES[name]
        before, met_1, grads_1, after_1, mem_1, _ = refs[name]
        met_2, grads_2, after_2, mem_2, every = res[name]
        path = f"{label} {name} step against one rank"
        for key in met_1:
            print(f"{path} {key}: {label} {met_2[key]:.6f} one rank "
                  f"{met_1[key]:.6f}", flush=True)
        close_losses(path, met_2, met_1, ("loss",), TOL[loss_tol])
        worst = leaf_updates(path, before, after_2, after_1, TOL[update_tol],
                             grads_g=grads_2, grads_c=grads_1)
        print(f"{path}: worst update rel L2 {worst:.3e} tol "
              f"{TOL[update_tol]:.0e}", flush=True)
        if mem_1 is not None:
            check(f"{path}: memory rows", max_err(mem_2[0], mem_1[0]),
                  TOL["par_memory"])
            if not torch.equal(mem_2[1], mem_1[1]):
                fail(f"{path}: memory ages differ")
        for rank, launches in enumerate(every):
            print(f"{path}: rank {rank} launches {launches}", flush=True)
            expect_counts(f"{label} {name} step, rank {rank}", launches,
                          PAR_LAUNCHES[name])
            total.update(launches)
    return total


def parallel_rank():
    """One of phase 14's two ranks on cuda:0 (parallel.launch.run_ranks
    starts each in a process of its own, over gloo): the joint and the
    memory step on a dp=2 mesh after rank 0's state is broadcast, then the
    joint step at B=8 global (four rows a rank). Returns the backend and,
    by step, rank 0's par_record with both ranks' launches (the B=8 step:
    its metrics and gradients, under "joint_b8")."""
    import torch
    import torch.distributed as dist
    from dl4ss_tpu_torch import resolve_device
    from dl4ss_tpu_torch.parallel.mesh import make_mesh, shard_state
    dev = resolve_device("cuda")
    mesh = make_mesh(2, 1, devices=[dev, dev])
    out = {"backend": dist.get_backend(), "steps": ("joint", "memory")}
    for name in out["steps"]:
        state, run = par_case(torch, dev, name, mesh)
        shard_state(state, mesh)
        *rec, launches = par_record(torch, state, run)
        every = [None] * mesh.dp
        dist.all_gather_object(every, launches)
        out[name] = (*rec, every)
    state, run = par_case(torch, dev, "joint", mesh, batch=BATCH // 2)
    shard_state(state, mesh)
    out["joint_b8"] = par_record(torch, state, run)[:2]
    return out


def parallel_phase(torch, dev, tmp):
    """14. The parallel layout and the utils on the card. a: run.train
    --preset torch_multi --dp auto, PAR_STEPS steps with the counts zeroed
    just before and read just after, against the same run without --dp:
    dp=1 on one card, no process group, the same launches (K1 2, K2 2, K5
    2, K3 1 with one W pack, K6 1 a step) and bit-equal parameters. b:
    run.train --dp 2 exits non-zero with JAX's message. c: two gloo ranks
    on cuda:0 run par_case's joint and memory steps, each held to the same
    step on one rank (TOL par_*), every rank launching the kernels. d:
    StepTimer, profile_trace and seed_everything. Returns the launches of
    a and c by kernel."""
    import random

    import torch.distributed as dist
    from dl4ss_tpu_torch.parallel.launch import run_ranks
    from dl4ss_tpu_torch.run import train as train_cli
    from dl4ss_tpu_torch.utils import (StepTimer, profile_trace,
                                       seed_everything)
    t_phase = time.perf_counter()
    total = collections.Counter()
    mode = subprocess.run(["nvidia-smi", "--query-gpu=compute_mode",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"parallel: compute mode {mode}", flush=True)

    # ---- a. --dp auto on one card -----------------------------------------
    argv = ["--preset", "torch_multi", "--seed", str(SEED), "--device",
            "cuda", "--utts", str(BANK_UTTS), "--epochs", "1",
            "--epoch-size", str(PAR_STEPS), "--eval-every", "0"]
    runs = {}
    for label, extra in (("--dp auto", ["--dp", "auto"]), ("no --dp", [])):
        zero_counts(torch)
        state, text = quiet(train_cli.main, argv + extra)
        launches, bodies = read_counts(torch, total if extra else None)
        runs[label] = (_leaves(state.model), launches, text)
        print(f"run.train --preset torch_multi {label}: step {state.step}; "
              f"launches {launches}, bodies {bodies}", flush=True)
        if state.step != PAR_STEPS:
            fail(f"run.train {label} ended at step {state.step}")
    auto, plain = runs["--dp auto"], runs["no --dp"]
    if dist.is_initialized() or "parallel:" in auto[2]:
        fail("--dp auto started a process group on one card")
    expect_counts("run.train --dp auto", auto[1],
                  {k: v * PAR_STEPS for k, v in PAR_LAUNCHES["joint"].items()})
    if auto[1] != plain[1]:
        fail(f"--dp auto launched {auto[1]}, without --dp {plain[1]}")
    moved = [n for n in plain[0] if not np.array_equal(auto[0][n],
                                                       plain[0][n])]
    print(f"run.train --dp auto against no --dp: {len(plain[0])} "
          f"parameters, {len(moved)} differ", flush=True)
    if moved:
        fail(f"--dp auto is not bit-equal to the run without --dp: {moved}")

    # ---- b. --dp 2 on one card --------------------------------------------
    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-m", "dl4ss_tpu_torch.run.train", "--preset",
         "torch_multi", "--dp", "2", "--epochs", "1", "--epoch-size", "1"],
        capture_output=True, text=True, cwd=here)
    want = (f"dp_size*mp_size = 2*1 exceeds the "
            f"{torch.cuda.device_count()} available device(s)")
    print(f"run.train --dp 2: exit {proc.returncode}, stderr "
          f"{proc.stderr.strip().splitlines()[-1:]}", flush=True)
    if proc.returncode == 0 or want not in proc.stderr:
        fail(f"run.train --dp 2 on one card: exit {proc.returncode}, "
             f"expected {want!r}")

    # ---- c. two ranks on one card -----------------------------------------
    refs = {}
    for name in ("joint", "memory"):
        state, run = par_case(torch, dev, name, None)
        refs[name] = (_leaves(state.model), *par_record(torch, state, run))
        del state, run
    t0 = time.perf_counter()
    res = run_ranks(parallel_rank, 2, backend="gloo", timeout=600)
    print(f"parallel: two ranks on cuda:0 over {res['backend']}, "
          f"{time.perf_counter() - t0:.1f} s with their start", flush=True)
    if res["backend"] != "gloo":
        fail(f"the ranks ran over {res['backend']}")
    total.update(hold_to_one_rank(torch, "dp=2", refs, res))
    # the same joint step at four rows a rank (B=8 over two ranks) against
    # one rank at B=8, printed and not gated: whether the gradient spread
    # that four cards showed at four rows a rank follows the local batch
    state, run = par_case(torch, dev, "joint", None, batch=BATCH // 2)
    one_b8 = par_record(torch, state, run)[:2]
    del state, run
    pairs = {"B=16": (refs["joint"][1:3], res["joint"][:2], BATCH // 2),
             "B=8": (one_b8, res["joint_b8"], BATCH // 4)}
    for label, ((met_1, grads_1), (met_2, grads_2), rows) in pairs.items():
        # the leaves the step moves (the classifier's gradient is zero)
        rels = {n: rel_l2(torch.as_tensor(grads_2[n]),
                          torch.as_tensor(grads_1[n]))
                for n in grads_1 if np.any(grads_1[n])}
        worst = max(rels, key=rels.get)
        print(f"parallel: joint step {label}, dp=2 at {rows} rows a rank "
              f"against one rank (not gated): loss {met_2['loss']:.6f} vs "
              f"{met_1['loss']:.6f}, worst gradient rel L2 "
              f"{rels[worst]:.3e} ({worst}), median "
              f"{statistics.median(rels.values()):.3e}", flush=True)
    # ---- d. the utils -----------------------------------------------------
    state, run = par_case(torch, dev, "joint", None)
    step_ms = StepTimer(warmup=1).time_chain(lambda s: run(s)[0], state,
                                             iters=1)
    print(f"utils.StepTimer: a chain of one joint step after one warm-up, "
          f"timed {step_ms > 0}", flush=True)
    if not (np.isfinite(step_ms) and step_ms > 0):
        fail(f"StepTimer timed the joint step at {step_ms} ms")
    with profile_trace(os.path.join(tmp, "trace")) as log_dir:
        run(state)
        torch.cuda.synchronize()
    path = os.path.join(log_dir, "trace.json")
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    print(f"utils.profile_trace: one joint step, {os.path.getsize(path)} "
          f"bytes, {len(events)} events, {kernels} kernel events",
          flush=True)
    if not kernels:
        fail("profile_trace recorded no kernel of the step")
    draws = []
    for _ in range(2):
        gen = seed_everything(SEED)
        draws.append([random.random(), *np.random.rand(3),
                      *torch.rand(3, device=dev).tolist(),
                      *torch.rand(3, generator=gen).tolist()])
    print(f"utils.seed_everything({SEED}) twice: {draws[0][:2]}..., equal "
          f"{draws[0] == draws[1]}", flush=True)
    if draws[0] != draws[1]:
        fail(f"seed_everything: {draws[0]} then {draws[1]}")
    print(f"parallel: phase 14 {time.perf_counter() - t_phase:.1f} s; "
          f"launches {dict(total)}", flush=True)
    return total


def parallel_only(torch) -> int:
    """`chip_smoke.py --parallel`: the kernels' build and phase 14 alone,
    then the card's line."""
    from dl4ss_tpu_torch import resolve_device
    from dl4ss_tpu_torch.ops import cuda_lib
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    cuda_lib.library()
    with tempfile.TemporaryDirectory() as tmp:
        parallel_phase(torch, dev, tmp)
    print(f"parallel: {time.perf_counter() - t0:.1f} s with the build",
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


# --cards: the speaker count of the dp x mp=2 step, which mp=2 divides
# (torch_multi's 103 rows would stay replicated, as JAX's rule keeps them)
CARDS_SPEAKERS = 104


def cards_rank(mp, names, speakers):
    """One rank of `--cards`, on its own card (run_ranks sets it) over
    NCCL: par_case's steps `names` on a (world / mp) x mp mesh from
    make_mesh's default devices, after rank 0's state is broadcast and the
    table's rows split. Returns what hold_to_one_rank reads: rank 0's
    par_record by step, a row-sharded leaf's parameters and gradients
    gathered whole over the model group, and every rank's launches."""
    import torch
    import torch.distributed as dist
    from dl4ss_tpu_torch.parallel.mesh import (make_mesh, rank_device,
                                               shard_state)
    dev = rank_device("cuda")
    world = dist.get_world_size()
    mesh = make_mesh(world // mp, mp)
    out = {"backend": dist.get_backend(), "steps": names, "sharded": [],
           "devices": [None] * world}
    dist.all_gather_object(out["devices"], str(mesh.device))
    for name in names:
        state, run = par_case(torch, dev, name, mesh, speakers)
        shard_state(state, mesh)
        sharded = sorted(n for n, p in state.model.named_parameters()
                         if getattr(p, "row_sharded", False))
        met, grads, after, memory, launches = par_record(torch, state, run)
        for n in sharded:
            for leaves in (grads, after):
                parts = [None] * mp
                dist.all_gather_object(parts, leaves[n],
                                       group=mesh.model_group)
                leaves[n] = np.concatenate(parts)
        every = [None] * world
        dist.all_gather_object(every, launches)
        out[name] = (met, grads, after, memory, every)
        out["sharded"] += sharded
    return out


def cards_only(torch) -> int:
    """`chip_smoke.py --cards`: the build, then the parallel steps and
    run.train over NCCL with one rank a card, on every visible card."""
    from dl4ss_tpu_torch import resolve_device
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.parallel.launch import backend_for, run_ranks
    from dl4ss_tpu_torch.run import train as train_cli
    n = torch.cuda.device_count()
    if n < 2 or n % 2:
        fail(f"--cards needs an even number of cards, two or more; {n} "
             f"visible")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    cuda_lib.library()
    print(f"cards: {n}, the kernels built in {time.perf_counter() - t0:.1f} "
          f"s", flush=True)
    for mp, names, speakers in ((1, ("joint", "memory"), None),
                                (2, ("joint",), CARDS_SPEAKERS)):
        label = f"dp={n // mp} x mp={mp}"
        refs = {}
        for name in names:
            state, run = par_case(torch, dev, name, None, speakers)
            refs[name] = (_leaves(state.model),
                          *par_record(torch, state, run))
            del state, run
        t1 = time.perf_counter()
        res = run_ranks(cards_rank, n, (mp, names, speakers),
                        backend=backend_for(dev), timeout=600)
        print(f"cards: {label}, {n} ranks over {res['backend']} on "
              f"{res['devices']}, {time.perf_counter() - t1:.1f} s with "
              f"their start; row-sharded {res['sharded']}", flush=True)
        if res["backend"] != "nccl" or len(set(res["devices"])) != n:
            fail(f"{label}: ran over {res['backend']} on {res['devices']}")
        if mp > 1 and res["sharded"] != ["embedding.table"]:
            fail(f"{label}: row-sharded {res['sharded']}, expected the "
                 f"embedding table")
        hold_to_one_rank(torch, label, refs, res)

    argv = ["--preset", "torch_multi", "--seed", str(SEED), "--device",
            "cuda", "--utts", str(BANK_UTTS), "--epochs", "1",
            "--epoch-size", str(PAR_STEPS), "--eval-every", "0"]
    one = _leaves(quiet(train_cli.main, argv)[0].model)
    for extra in (["--dp", "auto"], ["--dp", str(n // 2), "--mp", "2"]):
        state = train_cli.main(argv + extra)
        got = _leaves(state.model)
        diff = max(float(np.abs(got[k] - one[k]).max()) for k in one)
        print(f"run.train --preset torch_multi {' '.join(extra)}: step "
              f"{state.step}; largest parameter difference from the run "
              f"without --dp {diff:.3e}", flush=True)
        if state.step != PAR_STEPS or set(got) != set(one) or not all(
                np.isfinite(v).all() for v in got.values()):
            fail(f"run.train {' '.join(extra)}: step {state.step}, "
                 f"parameters {sorted(got)}")
    print(f"cards: {time.perf_counter() - t0:.1f} s with the build",
          flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    return 0


def surface_phase(torch, dev, smi):
    """15. The public surface. a: every module of dl4ss_tpu_torch imports
    (pkgutil.walk_packages) and neither JAX nor dl4ss_tpu is loaded. b:
    tests/test_torch_surface.py's walk of the JAX package's surface (its
    source read as text by `ast`) finds no name unmapped and no map entry
    stale, every counterpart resolved here. c: K2, K5, K7 and K8 with D = 1
    at B=16, T=313, H=300, both bodies, against their plain versions. d: a
    one-direction 2-layer GRU-300 and LSTM-300 stack (rnn_init(...,
    bidirectional=False)) over torch_multi's 129 features through
    `bidirectional_rnn(use_pallas=True)`, forward and gradients, with the
    counts zeroed just before and read just after: one K2 + one K5 (GRU)
    or K7 + K8 (LSTM) a layer, all on the body the rule names, held to the
    plain loop on the card (TOL uni_rnn_*). e: native.resample_poly
    against scipy on 5 s at 16 kHz -> 8 kHz. Returns (the D = 1 rows of
    the `kernels` line, the launches of d)."""
    import importlib.util
    import pkgutil

    import scipy.signal

    import dl4ss_tpu_torch
    from dl4ss_tpu_torch import native, preset
    from dl4ss_tpu_torch.ops import rnn_kernels as k2
    from dl4ss_tpu_torch.ops.rnn import bidirectional_rnn, rnn_init
    t_phase = time.perf_counter()
    print(f"surface: {smi}", flush=True)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    # ---- a. every module imports, without JAX -----------------------------
    broken, names = {}, []
    for info in pkgutil.walk_packages(dl4ss_tpu_torch.__path__,
                                      "dl4ss_tpu_torch.",
                                      onerror=lambda n: broken.setdefault(
                                          n, "walk failed")):
        names.append(info.name)
        try:
            importlib.import_module(info.name)
        except Exception as e:          # every failure, then one verdict
            broken[info.name] = f"{type(e).__name__}: {e}"
    print(f"surface: {len(names)} modules of dl4ss_tpu_torch imported, "
          f"{len(broken)} failed", flush=True)
    if broken:
        fail(f"modules that do not import: {broken}")

    def leaked():
        return sorted(m for m in sys.modules
                      if m.split(".")[0] in ("jax", "jaxlib", "dl4ss_tpu"))
    if leaked():
        fail(f"the port loaded {leaked()}")

    # ---- b. the surface map -------------------------------------------------
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        "torch_surface", os.path.join(here, "tests", "test_torch_surface.py"))
    surface = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(surface)
    defs, exports = surface.jax_surface()
    unmapped, stale = surface.surface_problems()
    print(f"surface: {len(defs)} JAX definitions and {len(exports)} "
          f"package exports walked, {len(surface.MAP)} map entries; "
          f"unmapped {unmapped}, stale {stale}", flush=True)
    if unmapped or stale or leaked():
        fail(f"surface: unmapped {unmapped}, stale {stale}, loaded "
             f"{leaked()}")

    # ---- c. the recurrent kernels with D = 1 ------------------------------
    cfg = preset("torch_multi")
    H, F, T, B = cfg.hidden_units, cfg.freq_bins, cfg.num_frames, BATCH
    rng = np.random.default_rng(SEED + 15)
    sc = 1.0 / np.sqrt(H)

    def tensor(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev
                               ).contiguous()

    for name in ("gru_fwd", "gru_bwd"):
        rule = k2.default_body(dev, name, torch.float32, H, B, 1)
        print(f"surface: the rule at H={H}, B={B}, directions=1, {name}: "
              f"{rule}, {len(k2.resident_chunks(B, H, 1, sms))} ticket "
              f"launch(es) of {k2.resident_chunk_rows(H, 1, sms)} rows",
              flush=True)
    xp2 = tensor(0.5 * rng.standard_normal((T, 1, B, 3 * H)))
    wh2 = tensor(rng.uniform(-sc, sc, (1, H, 3 * H)))
    bhn = tensor(rng.uniform(-sc, sc, (1, 1, H)))
    xp7 = tensor(0.5 * rng.standard_normal((T, 1, B, 4 * H)))
    wh7 = tensor(rng.uniform(-sc, sc, (1, H, 4 * H)))
    dhs = tensor(rng.standard_normal((T, 1, B, H)))
    errs = {"gru_fwd": check_bodies_on(
        torch, "K2 gru_fwd D=1", "gru_fwd", k2.gru_scan_cuda,
        k2.gru_scan_plain, (xp2, wh2, bhn), ("hs",), TOL["gru_fwd"],
        rel=False)}
    hs = k2.gru_scan_cuda(xp2, wh2, bhn)
    zeros = torch.zeros_like(hs[:1])
    k5_args = (xp2, wh2, bhn, torch.cat([zeros, hs[:-1]]), dhs)
    errs["gru_bwd"] = check_bodies_on(
                    torch, "K5 gru_bwd D=1", "gru_bwd",
                    k2.gru_scan_bwd_cuda, k2.gru_scan_bwd_plain, k5_args,
                    ("dxp", "dU", "db_n"), TOL["gru_bwd"], rel=True)
    errs["lstm_fwd"] = check_bodies_on(
                    torch, "K7 lstm_fwd D=1", "lstm_fwd",
                    k2.lstm_scan_cuda, k2.lstm_scan_plain, (xp7, wh7),
                    ("hs", "cs"), TOL["lstm_fwd"], rel=False)
    hs7, cs7 = k2.lstm_scan_cuda(xp7, wh7)
    k8_args = (xp7, wh7, torch.cat([zeros, hs7[:-1]]),
               torch.cat([zeros, cs7[:-1]]), cs7, dhs)
    errs["lstm_bwd"] = check_bodies_on(
                    torch, "K8 lstm_bwd D=1", "lstm_bwd",
                    k2.lstm_scan_bwd_cuda, k2.lstm_scan_bwd_plain, k8_args,
                    ("dxp", "dU"), TOL["lstm_bwd"], rel=True)

    # ---- d. the one-direction stacks through the public entry point -------
    x = tensor(np.abs(rng.standard_normal((B, T, F))))
    cot = tensor(rng.standard_normal((B, T, H)))
    stacks = {cell: rnn_init(cell, F, H, SURFACE_LAYERS,
                             torch.Generator().manual_seed(SEED), device=dev,
                             bidirectional=False)
              for cell in ("gru", "lstm")}

    def run(cell, kernels):
        leaves = [x.clone().requires_grad_(), *stacks[cell].parameters()]
        out = bidirectional_rnn(stacks[cell], leaves[0], cell,
                                use_pallas=kernels)
        grads = torch.autograd.grad((out * cot).sum(), leaves)
        return out.detach(), grads

    got = {}
    zero_counts(torch)
    for cell in stacks:
        got[cell] = run(cell, True)
    launches, bodies = read_counts(torch)
    print(f"surface: one-direction stacks, forward and backward: launches "
          f"{launches}, bodies {bodies}", flush=True)
    want = {n: SURFACE_LAYERS for n in ("gru_fwd", "gru_bwd", "lstm_fwd",
                                        "lstm_bwd")}
    expect_counts("surface: one-direction stacks", launches,
                  {**want, "stft_features": 0, "maskhead_fwd": 0,
                   "masked_istft": 0})
    for name in want:
        rule = k2.default_body(dev, name, torch.float32, H, B, 1)
        if bodies != {**bodies, (name, rule): SURFACE_LAYERS}:
            fail(f"surface: {name} ran {bodies}, expected "
                 f"{SURFACE_LAYERS} launches of the {rule} body")
    for cell in stacks:
        out_p, grads_p = run(cell, False)
        out_k, grads_k = got[cell]
        if tuple(out_k.shape) != (B, T, H) or not bool(
                torch.isfinite(out_k).all()):
            fail(f"surface: {cell} stack gave {tuple(out_k.shape)}, "
                 f"finite {bool(torch.isfinite(out_k).all())}")
        check(f"surface: one-direction {cell.upper()} stack on the kernels "
              f"against the plain loop, output", max_err(out_k, out_p),
              TOL["uni_rnn_fwd"])
        names = ["input", *(n for n, _ in stacks[cell].named_parameters())]
        rels = {n: rel_l2(g, r) for n, g, r in zip(names, grads_k, grads_p)}
        worst = max(rels, key=rels.get)
        print(f"surface: {cell} stack gradient rel L2 by leaf: "
              + ", ".join(f"{n} {r:.2e}" for n, r in rels.items()),
              flush=True)
        for n, g, r in zip(names, grads_k, grads_p):
            check_rel(f"surface: {cell} stack gradient of {n}", g, r,
                      TOL["uni_rnn_bwd"])
        print(f"surface: {cell} stack worst gradient {rels[worst]:.3e} "
              f"({worst})", flush=True)

    # ---- the D = 1 rows of the kernels line ---------------------------------
    gru = torch.nn.GRU(H, H, batch_first=True).to(dev)
    lstm = torch.nn.LSTM(H, H, batch_first=True).to(dev)
    lib_x = torch.randn((B, T, H), device=dev, requires_grad=True)
    lib = {}
    for name, mod in (("gru", gru), ("lstm", lstm)):
        out, _ = mod(lib_x)
        lib[name] = (out, [lib_x, *mod.parameters()], torch.randn_like(out))
    hp8, cp8 = k8_args[2], k8_args[3]
    rows = {
        "gru_fwd": dict(
            source="dl4ss_tpu_torch/csrc/gru_fwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:104",
            kernel=lambda: k2.gru_scan_cuda(xp2, wh2, bhn),
            plain=lambda: k2.gru_scan_plain(xp2, wh2, bhn),
            library=lambda: gru(lib_x.detach()),
            bytes=4 * (xp2.numel() + wh2.numel() + bhn.numel() + T * B * H),
            t_ops=T * B * (2 * H * 3 * H + 12 * H) / F32_FLOPS, iters=(20, 3)),
        "gru_bwd": dict(
            source="dl4ss_tpu_torch/csrc/gru_bwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:164",
            kernel=lambda: k2.gru_scan_bwd_cuda(*k5_args),
            plain=lambda: k2.gru_scan_bwd_plain(*k5_args),
            library=lambda: torch.autograd.grad(
                lib["gru"][0], lib["gru"][1], lib["gru"][2],
                retain_graph=True),
            bytes=4 * (2 * xp2.numel() + 2 * hs.numel() + 2 * wh2.numel()
                       + 2 * bhn.numel()),
            t_ops=T * B * (3 * 2 * H * 3 * H + 30 * H) / F32_FLOPS,
            iters=(10, 2)),
        "lstm_fwd": dict(
            source="dl4ss_tpu_torch/csrc/lstm_fwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:257",
            kernel=lambda: k2.lstm_scan_cuda(xp7, wh7),
            plain=lambda: k2.lstm_scan_plain(xp7, wh7),
            library=lambda: lstm(lib_x.detach()),
            bytes=4 * (xp7.numel() + wh7.numel() + 2 * T * B * H),
            t_ops=T * B * (2 * H * 4 * H + 25 * H) / F32_FLOPS, iters=(20, 3)),
        "lstm_bwd": dict(
            source="dl4ss_tpu_torch/csrc/lstm_bwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:316",
            kernel=lambda: k2.lstm_scan_bwd_cuda(*k8_args),
            plain=lambda: k2.lstm_scan_bwd_plain(*k8_args),
            library=lambda: torch.autograd.grad(
                lib["lstm"][0], lib["lstm"][1], lib["lstm"][2],
                retain_graph=True),
            bytes=4 * (2 * xp7.numel() + hp8.numel() + cp8.numel()
                       + cs7.numel() + dhs.numel() + 2 * wh7.numel()),
            t_ops=T * B * (3 * 2 * H * 4 * H + 45 * H) / F32_FLOPS,
            iters=(10, 2)),
    }
    kernels = []
    for name, r in rows.items():
        k_iters, p_iters = r["iters"]
        ms = device_ms(torch, r["kernel"], k_iters)
        plain_ms = device_ms(torch, r["plain"], p_iters)
        lib_ms = device_ms(torch, r["library"], 10)
        bound_ms, bound_by = bound(r["bytes"], r["t_ops"])
        kernels.append(dict(
            name=f"{name}_d1", route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[name],
            max_abs_err=errs[name], ms=ms,
            plain_ms=plain_ms, bound_ms=bound_ms, bound_by=bound_by,
            library_ms=lib_ms))
        print(f"time {name} D=1 B={B}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, library {lib_ms:.4f} ms (one-direction "
              f"nn.{'GRU' if 'gru' in name else 'LSTM'}), bound "
              f"{bound_ms:.4f} ms ({bound_by})", flush=True)

    # ---- e. the native resampler against scipy ----------------------------
    wav16 = rng.standard_normal(5 * 16000).astype(np.float32)
    t0 = time.perf_counter()
    ours = native.resample_poly(wav16, 1, 2)
    res_ms = (time.perf_counter() - t0) * 1e3
    ref = scipy.signal.resample_poly(
        wav16.astype(np.float64), 1, 2,
        window=("kaiser", native.KAISER_BETA)).astype(np.float32)
    if ours.shape != ref.shape:
        fail(f"native.resample_poly gave {ours.shape}, scipy {ref.shape}")
    check(f"native.resample_poly 5 s 16 kHz -> 8 kHz ({ours.shape[0]} "
          f"samples, {res_ms:.2f} ms on the host, first call after the "
          f"build) against scipy", float(np.abs(ours - ref).max()),
          TOL["resample"])
    print(f"surface: phase 15 {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return kernels, launches


def surface_only(torch) -> int:
    """`chip_smoke.py --surface`: the kernels' build and phase 15 alone,
    then its kernel rows and the card's line."""
    from dl4ss_tpu_torch import resolve_device
    from dl4ss_tpu_torch.ops import cuda_lib
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    t0 = time.perf_counter()
    cuda_lib.library()
    kernels, _ = surface_phase(torch, dev, smi)
    print(f"surface: {time.perf_counter() - t0:.1f} s with the build",
          flush=True)
    print(json.dumps({"kernels": kernels}))
    print(smi)
    return 0


def main(argv=None) -> int:
    import torch
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if argv[:1] == ["--learning"] and len(argv) == 2:
        return learning_curve(torch, int(argv[1]))
    if argv == ["--rehearsal"]:
        return rehearsal(torch)
    if argv == ["--generations"]:
        return generations(torch)
    if argv == ["--parallel"]:
        return parallel_only(torch)
    if argv == ["--cards"]:
        return cards_only(torch)
    if argv == ["--surface"]:
        return surface_only(torch)
    if argv:
        print("usage: chip_smoke.py [--learning STEPS | --rehearsal | "
              "--generations | --parallel | --cards | --surface]",
              file=sys.stderr)
        return 2
    from dl4ss_tpu_torch import preset, resolve_device
    from dl4ss_tpu_torch.models import init_separator
    from dl4ss_tpu_torch.ops import cuda_lib
    from dl4ss_tpu_torch.ops import maskhead_kernels as k3
    from dl4ss_tpu_torch.ops import rnn_kernels as k2
    from dl4ss_tpu_torch.ops import stft_kernels as k14
    from dl4ss_tpu_torch.ops.stft import reflect_pad
    from dl4ss_tpu_torch.serve import select_and_separate, separate_waveforms

    # ---- 1. card and build ------------------------------------------------
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    dev = resolve_device("cuda")
    SMS = torch.cuda.get_device_properties(dev).multi_processor_count
    print(f"card: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | tf32 matmul="
          f"{torch.backends.cuda.matmul.allow_tf32} cudnn="
          f"{torch.backends.cudnn.allow_tf32}", flush=True)
    t0 = time.perf_counter()
    lib = cuda_lib.library()
    print(f"build: {len(cuda_lib.SOURCES)} kernels, nvcc "
          f"{lib.build_seconds:.1f} s, load {time.perf_counter() - t0:.1f} s "
          f"-> {lib.path.name}", flush=True)
    log = lib.log.splitlines()
    for line in log:
        if "Used" in line or "spill" in line:
            print("  ptxas:", line.strip(), file=sys.stderr)
    for i, line in enumerate(log):     # the resident chains, one line each
        if "Compiling entry" in line and "_chain_kernel" in line:
            name = line.split("'")[1]
            kind = "fwd" if "fwd_chain" in name else "bwd"
            cell = next(c for c in ("Gru", "Lstm") if c in name)
            dtype = "bf16" if "bfloat16" in name else "f32"
            # the forward's body: the wide or tiled one, or the ticket
            # (Lb0) or cluster (Lb1) body at its units a block
            units = name.split("EEELb")[0].rsplit("Li", 1)[-1]
            body = ("wide" if "wide" in name else
                    "tiled" if "5tiled" in name else
                    f"cluster {units} units" if "ELb1E" in name else
                    "ticket" if "ELb0E" in name else "")
            info = " ".join(x.strip() for x in log[i + 1:i + 4])
            regs = info.split("Used ")[1].split(" registers")[0]
            spill = info.split("spill stores")[0].split(",")[-1].strip()
            print(f"ptxas {cell} {kind} chain {dtype} {body}: {regs} "
                  f"registers, {spill} spill stores", flush=True)
    mask_kernels = ("maskhead_fwd_kernel", "maskhead_bwd_kernel",
                    "maskhead_pack_kernel", "maskhead_sums_kernel")
    for i, line in enumerate(log):     # K3 and K6 (wgmma), their helpers
        if "Compiling entry" in line and any(k in line for k in mask_kernels):
            name = line.split("'")[1]
            kern = next(k for k in mask_kernels if k in name)
            # the template argument: K3's output / the pack's input type,
            # K6's query count
            after = name.split(kern)[1]
            arg = ("f32" if after.startswith("IfE") else
                   "bf16" if after.startswith("I13__nv_bfloat16E") else
                   f"K={after[3]}" if after.startswith("ILi") else "")
            info = " ".join(x.strip() for x in log[i + 1:i + 4])
            regs = info.split("Used ")[1].split(" registers")[0]
            spill = info.split("spill stores")[0].split(",")[-1].strip()
            print(f"ptxas {kern} {arg}: {regs} registers, {spill} spill "
                  f"stores", flush=True)
    for line in log:
        if "wgmma" in line or "Performance Loss" in line:
            print(f"ptxas note: {line.strip()}", flush=True)

    cfg = preset("torch_multi")
    L, hop, F = cfg.frame_length, cfg.frame_shift, cfg.freq_bins
    H, E, K = cfg.hidden_units, cfg.embedding_size, cfg.top_k
    rng = np.random.default_rng(SEED)

    def tensor(a, dtype=torch.float32):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev
                               ).to(dtype).contiguous()

    # ---- 2. the kernels' inputs at the path shapes (B=16, T=313) ---------
    # (each kernel against its plain version: tests/test_torch_cuda.py)
    wav = tensor(rng.uniform(-1, 1, (BATCH, N_SAMPLES)))
    xpad = reflect_pad(wav, L // 2).contiguous()
    _, re, im = k14.stft_features_cuda(xpad, L, hop, cfg.window,
                                       torch.float32)
    T = re.shape[1]
    # K2 (T=313, D=2, H=300) at B=16 and B=32
    scale = 1.0 / np.sqrt(H)
    xp = tensor(0.5 * rng.standard_normal((T, 2, BATCH, 3 * H)))
    wh = tensor(rng.uniform(-scale, scale, (2, H, 3 * H)))
    bhn = tensor(rng.uniform(-scale, scale, (2, 1, H)))
    xp32 = tensor(0.5 * rng.standard_normal((T, 2, 2 * BATCH, 3 * H)))
    # K3 (B=16, T=313, D=600, F=129, E=50, K=2)
    d2 = 2 * H
    hb = tensor(rng.uniform(-1, 1, (BATCH, T, d2)), torch.bfloat16)
    s2 = 1.0 / np.sqrt(d2)
    wb = tensor(rng.uniform(-s2, s2, (d2, F * E)), torch.bfloat16)
    bias = tensor(rng.uniform(-s2, s2, (F * E,)))
    qb = tensor(rng.standard_normal((BATCH, K, E)), torch.bfloat16)
    k3_args = (hb, wb, bias, qb, F, E, torch.float32)
    # K4 on K1's spectra, with f32 and bf16 masks at B=16 and B=1
    masks = tensor(rng.uniform(0, 1, (BATCH, K, T, F)))
    k4_args = (re, im, masks, L, hop, cfg.window)
    k4_cases = {label: (re[:b_n], im[:b_n], masks[:b_n].to(dt), L, hop,
                        cfg.window)
                for label, b_n, dt in (
                    (f"B={BATCH}", BATCH, torch.float32),
                    (f"B={BATCH} bf16 masks", BATCH, torch.bfloat16),
                    ("B=1", 1, torch.float32),
                    ("B=1 bf16 masks", 1, torch.bfloat16))}
    # K5 at B=16 (f32 and bf16), 32 and 128 (two and seven resident
    # launches), on its forward's own hs
    dhs = tensor(rng.standard_normal((T, 2, 8 * BATCH, H)))
    xp128 = tensor(0.5 * rng.standard_normal((T, 2, 8 * BATCH, 3 * H)))
    k5_args = {}
    for label, dt, x5 in (("f32", torch.float32, xp),
                          ("bf16", torch.bfloat16, xp),
                          (f"f32 B={2 * BATCH}", torch.float32, xp32),
                          (f"f32 B={8 * BATCH}", torch.float32, xp128)):
        x5, w5 = x5.to(dt), wh.to(dt)
        hs = k2.gru_scan_cuda(x5, w5, bhn)
        k5_args[label] = (x5, w5, bhn,
                          torch.cat([torch.zeros_like(hs[:1]), hs[:-1]]),
                          dhs[:, :, :x5.shape[2]].contiguous().to(dt))
    # K6 on K3's own bf16 masks
    masks6 = k3.fused_dot_masks_cuda(hb, wb, bias, qb, F, E, torch.bfloat16)
    dout6 = tensor(rng.standard_normal((BATCH, K, T, F)), torch.bfloat16)
    k6_args = (hb, wb, bias, qb, masks6, dout6, F, E)
    dacc, dq, db = k3.fused_dot_masks_bwd_cuda(*k6_args)

    # K7 and K8 at the classifier's shapes (T=313, D=2, H=300): B=16 in f32
    # and bf16, B=32 and 128, and B=16 at H=600 (the TDAA classifier
    # width); K8 on K7's own hs and cs
    def lstm_case(hidden, dt, batch=BATCH):
        sc = 1.0 / np.sqrt(hidden)
        x7 = tensor(0.5 * rng.standard_normal((T, 2, batch, 4 * hidden)), dt)
        w7 = tensor(rng.uniform(-sc, sc, (2, hidden, 4 * hidden)), dt)
        g7 = tensor(rng.standard_normal((T, 2, batch, hidden)), dt)
        hs7, cs7 = k2.lstm_scan_cuda(x7, w7)
        zeros = torch.zeros_like(hs7[:1])
        return (x7, w7), (
            x7, w7, torch.cat([zeros, hs7[:-1]]),
            torch.cat([zeros, cs7[:-1]]), cs7, g7)

    k8_args = {}
    for label, hidden, dt, batch in (
            ("f32", H, torch.float32, BATCH),
            ("bf16", H, torch.bfloat16, BATCH),
            (f"f32 B={2 * BATCH}", H, torch.float32, 2 * BATCH),
            (f"f32 B={8 * BATCH}", H, torch.float32, 8 * BATCH),
            (f"f32 H={WIDE}", WIDE, torch.float32, BATCH)):
        k7_args, k8_args[label] = lstm_case(hidden, dt, batch)
        if label == "f32":
            x7, w7 = k7_args
    # K9's packed halves, K10's input
    ri_c = k14.stft_ri_cuda(xpad, L, hop, cfg.window)

    # ---- 3. round trip ----------------------------------------------------
    ones = torch.ones((BATCH, 1, T, F), device=dev)
    _, re1, im1 = k14.stft_features(wav, L, hop, cfg.window)
    rec = k14.masked_istft(re1, im1, ones, L, hop, cfg.window)[:, 0]
    if rec.shape[-1] != (T - 1) * hop:
        fail(f"round trip length {rec.shape[-1]} != {(T - 1) * hop}")
    check("round trip K1->K4", max_err(rec, wav[:, :rec.shape[-1]]),
          TOL["round_trip"])
    # the packed STFT and iSTFT have no caller in the package: their path
    # is the public `ops` exports, driven here as a user would
    from dl4ss_tpu_torch import ops
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    k14.BODY_LAUNCHES.clear()
    rec2 = ops.istft_kernel(ops.stft_kernel(wav, L, hop, cfg.window), L, hop,
                            cfg.window, length=N_SAMPLES)
    torch.cuda.synchronize()
    dsp_launches = dict(cuda_lib.LAUNCHES)
    print(f"public STFT/iSTFT launches: {dsp_launches}; bodies "
          f"{dict(k14.BODY_LAUNCHES)}", flush=True)
    if dsp_launches != {"stft_ri": 1, "istft_ri": 1}:
        fail(f"ops.stft_kernel / ops.istft_kernel launched {dsp_launches}")
    if dict(k14.BODY_LAUNCHES) != {("stft_ri", k14.BODY_FFT): 1,
                                   ("istft_ri", k14.BODY_FFT): 1}:
        fail(f"the public STFT/iSTFT round trip did not run the FFT bodies: "
             f"{dict(k14.BODY_LAUNCHES)}")
    if tuple(rec2.shape) != (BATCH, N_SAMPLES):
        fail(f"round trip K9->K10 shape {tuple(rec2.shape)}")
    n_rec = (T - 1) * hop       # past it the signal was never framed
    check("round trip K9->K10", max_err(rec2[:, :n_rec], wav[:, :n_rec]),
          TOL["round_trip"])
    if bool(rec2[:, n_rec:].any()):
        fail("round trip K9->K10: the tail past (T-1)*hop is not zero")

    # ---- 4. end to end: torch_multi at full width -------------------------
    model = init_separator(cfg, torch.Generator().manual_seed(SEED), dev)
    plain_cfg = cfg.replace(use_pallas_stft=False, use_pallas_rnn=False,
                            use_pallas_maskhead=False)
    spk = torch.as_tensor(rng.integers(0, cfg.num_speakers, (BATCH, K)),
                          device=dev)
    reqs = [(tensor(rng.uniform(-1, 1, (1, N_SAMPLES))),
             torch.as_tensor(rng.integers(0, cfg.num_speakers, (1, K)),
                             device=dev)) for _ in range(REQUESTS)]
    def check_chain_bodies(path, name, count):
        """Every launch of K2 or K7 on a main path ran the cluster body, of
        K5 or K8 the resident one: the bodies the shape rule names at the
        paths' shapes (H=300, B=1 and 16) on an H100."""
        want = (k2.BODY_RESIDENT if name.endswith("_bwd")
                else k2.BODY_CLUSTER)
        bodies = {b: n for (kern, b), n in k2.BODY_LAUNCHES.items()
                  if kern == name}
        print(f"{path}: {name} bodies {bodies}", flush=True)
        if bodies != {want: count}:
            fail(f"{path}: {name} launched {bodies}, expected {count} "
                 f"launches of the {want} body")

    def check_fft_bodies(path, counts):
        """Every K1 and K4 launch of a serving path ran the FFT body, the
        one the shape rules name at torch_multi's frame shape."""
        want = {(name, k14.BODY_FFT): counts.get(name)
                for name in ("stft_features", "masked_istft")}
        if dict(k14.BODY_LAUNCHES) != want:
            fail(f"{path}: the STFT / iSTFT launches were not all the FFT "
                 f"body: {dict(k14.BODY_LAUNCHES)}, expected {want}")

    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    k14.BODY_LAUNCHES.clear()
    k2.BODY_LAUNCHES.clear()
    out16 = separate_waveforms(model, wav, cfg, spk, length=N_SAMPLES)
    outs1 = [separate_waveforms(model, w, cfg, s, length=N_SAMPLES)
             for w, s in reqs]
    torch.cuda.synchronize()
    launches = dict(cuda_lib.LAUNCHES)
    print(f"main path launches: {launches}; STFT and iSTFT bodies "
          f"{dict(k14.BODY_LAUNCHES)}", flush=True)
    check_fft_bodies("given-speaker serving", launches)
    launches.update(dsp_launches)
    missing = [n for n in cuda_lib.SERVING_KERNELS if not launches.get(n)]
    if missing:
        fail(f"kernels never launched on the serving path: {missing}")
    check_chain_bodies("given-speaker serving", "gru_fwd", launches["gru_fwd"])
    if launches["maskhead_fwd"] != 1 + REQUESTS:
        fail(f"given-speaker serving launched K3 {launches['maskhead_fwd']} "
             f"times, expected one per call ({1 + REQUESTS})")
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

    # classifier-selected speakers: the same batch and requests with no
    # speakers given
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    k14.BODY_LAUNCHES.clear()
    k2.BODY_LAUNCHES.clear()
    sel16 = separate_waveforms(model, wav, cfg, length=N_SAMPLES)
    sels1 = [separate_waveforms(model, w, cfg, length=N_SAMPLES)
             for w, _ in reqs]
    torch.cuda.synchronize()
    sel_launches = dict(cuda_lib.LAUNCHES)
    print(f"classifier-selected path launches: {sel_launches}; STFT and "
          f"iSTFT bodies {dict(k14.BODY_LAUNCHES)}", flush=True)
    check_fft_bodies("classifier-selected serving", sel_launches)
    calls = 1 + REQUESTS
    want = {"stft_features": calls, "gru_fwd": cfg.encoder_layers * calls,
            "lstm_fwd": cfg.classifier_layers * calls, "maskhead_fwd": calls,
            "masked_istft": calls}
    got = {n: sel_launches.get(n, 0) for n in cuda_lib.SELECTION_KERNELS}
    if got != want:
        fail(f"classifier-selected path launched {got}, expected {want}")
    for name in ("gru_fwd", "lstm_fwd"):
        check_chain_bodies("classifier-selected serving", name, want[name])
    launches["lstm_fwd"] = sel_launches["lstm_fwd"]
    from dl4ss_tpu_torch.models import classify_speakers
    from dl4ss_tpu_torch.ops.stft import spectral_feature_cfg
    compared = 0
    for name, mix, got_wav in ([(f"B={BATCH}", wav, sel16)] + [
            (f"B=1 #{i}", w, o) for i, ((w, _), o)
            in enumerate(zip(reqs, sels1))]):
        shape = (mix.shape[0], K, N_SAMPLES)
        if tuple(got_wav.shape) != shape or not bool(
                torch.isfinite(got_wav).all()):
            fail(f"selected {name}: shape {tuple(got_wav.shape)} (want "
                 f"{shape}) or non-finite values")
        # the plain path's probabilities say which rows have a clear top-k
        with torch.inference_mode():
            probs = classify_speakers(
                model, spectral_feature_cfg(mix, plain_cfg)[0], plain_cfg)
        ranked = probs.sort(dim=-1, descending=True).values
        clear = ((ranked[:, :K] - ranked[:, 1:K + 1]).min(dim=-1).values
                 > TOL["selection_gap"])
        _, spk_k = select_and_separate(model, mix, cfg, length=N_SAMPLES)
        ref_wav, spk_p = select_and_separate(model, mix, plain_cfg,
                                             length=N_SAMPLES)
        if not torch.equal(spk_k[clear], spk_p[clear]):
            fail(f"selected {name}: kernel route picked {spk_k.tolist()}, "
                 f"plain route {spk_p.tolist()}")
        compared += int(clear.sum())
        forced = separate_waveforms(model, mix, cfg, spk_p, length=N_SAMPLES)
        same = bool(torch.equal(spk_k, spk_p))
        rel = float((forced - ref_wav).norm() / ref_wav.norm())
        print(f"selected {name}: speakers {spk_k[0].tolist()} "
              f"(plain {spk_p[0].tolist()}, {int(clear.sum())} of "
              f"{mix.shape[0]} rows clear), rel_l2_vs_plain={rel:.3e} with "
              f"the plain path's speakers forced, tol_rel="
              f"{TOL['end_to_end_rel']:.0e}", flush=True)
        if not rel <= TOL["end_to_end_rel"]:
            fail(f"selected {name} differs from the plain path: {rel}")
        if same and max_err(forced, got_wav) > 1e-6:
            fail(f"selected {name}: the selected run and the run forced to "
                 f"the same speakers differ")
    print(f"selection: {compared} of {BATCH + REQUESTS} rows had a clear "
          f"top-{K} (gap > {TOL['selection_gap']:.0e}) and agree", flush=True)

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
        from dl4ss_tpu_torch.data.wavio import read_wav
        rec_dir = os.path.join(tmp, "recursive")
        torch.cuda.synchronize()
        cuda_lib.LAUNCHES.clear()
        k2.BODY_LAUNCHES.clear()
        separate_cli.main([*paths, "--mode", "recursive", "--out", rec_dir,
                           "--device", "cuda"])
        torch.cuda.synchronize()
        rec_launches = dict(cuda_lib.LAUNCHES)
        wrote = sorted(os.listdir(rec_dir))
        steps = cfg.recursive_max_steps
        if len(wrote) != 2 * steps:
            fail(f"recursive CLI wrote {wrote}, expected {2 * steps} wavs")
        for name in wrote:
            data, _ = read_wav(os.path.join(rec_dir, name))
            if data.shape != (N_SAMPLES,) or not np.isfinite(data).all():
                fail(f"recursive CLI: {name} has shape {data.shape} or "
                     f"non-finite samples")
        # both wavs ride one batch: every peel step runs the encoder (K2)
        # and the classifier (K7), one launch per layer
        want = {"gru_fwd": cfg.encoder_layers * steps,
                "lstm_fwd": cfg.classifier_layers * steps}
        got = {n: rec_launches.get(n, 0) for n in want}
        print(f"recursive CLI: wrote {wrote}, launches {rec_launches}",
              flush=True)
        if got != want:
            fail(f"recursive CLI launched {got}, expected {want}")
        for name, count in want.items():
            check_chain_bodies("recursive CLI", name, count)

    # ---- 6. train step: kernel route on the card against the CPU --------
    from dl4ss_tpu_torch.data.synth import (featurize, make_synthetic_bank,
                                            sample_mixtures)
    from dl4ss_tpu_torch.train.state import create_train_state
    from dl4ss_tpu_torch.train.steps import (make_classifier_step,
                                             make_fused_step,
                                             make_train_step)
    from dl4ss_tpu_torch.weights import export_jax_params, flatten_tree

    def leaves(m):
        return dict(flatten_tree(export_jax_params(m)))

    bank = torch.as_tensor(make_synthetic_bank(
        SEED, cfg.num_speakers, BANK_UTTS, N_SAMPLES), device=dev)
    feats = featurize(sample_mixtures(torch.Generator().manual_seed(SEED),
                                      bank, cfg), cfg)
    twin = copy.deepcopy(model).to("cpu")
    before = leaves(model)
    step = make_train_step(cfg)
    _, met_g = step(create_train_state(cfg, model=model), feats)
    _, met_c = step(create_train_state(cfg, model=twin, device="cpu"),
                    {k: v.cpu() for k, v in feats.items()})
    for key in ("loss", "grad_norm"):
        got, ref = float(met_g[key]), float(met_c[key])
        rel = abs(got - ref) / abs(ref)
        print(f"train step {key}: card {got:.6f} cpu {ref:.6f} rel {rel:.3e} "
              f"tol {TOL['train_loss_rel']:.0e}", flush=True)
        if not (np.isfinite(got) and rel <= TOL["train_loss_rel"]):
            fail(f"train step {key} differs: card {got}, cpu {ref}")
    after_g, after_c = leaves(model), leaves(twin)
    worst = 0.0
    for name, ref in after_c.items():
        want, got = ref - before[name], after_g[name] - before[name]
        if not np.any(want):
            if np.any(got):
                fail(f"train step moved {name}, which the CPU step left")
            continue
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        worst = max(worst, rel)
        if not rel <= TOL["train_update_rel"]:
            fail(f"train step update of {name}: rel L2 {rel}")
    print(f"train step updates: {len(after_c)} leaves, worst rel L2 "
          f"{worst:.3e} tol {TOL['train_update_rel']:.0e}", flush=True)

    # the classifier step (K7 forward, K8 backward) the same way: loss,
    # element accuracy and every classifier leaf's update; the encoder,
    # the embedding and the mask head get no gradient on either side
    twin = copy.deepcopy(model).to("cpu")
    before = leaves(model)
    cstep = make_classifier_step(cfg)
    cuda_lib.LAUNCHES.clear()
    _, cmet_g = cstep(create_train_state(cfg, model=model), feats)
    torch.cuda.synchronize()
    cstep_launches = dict(cuda_lib.LAUNCHES)
    _, cmet_c = cstep(create_train_state(cfg, model=twin, device="cpu"),
                      {k: v.cpu() for k, v in feats.items()})
    got, ref = float(cmet_g["loss"]), float(cmet_c["loss"])
    rel = abs(got - ref) / abs(ref)
    acc_g, acc_c = float(cmet_g["element_acc"]), float(cmet_c["element_acc"])
    print(f"classifier step loss: card {got:.6f} cpu {ref:.6f} rel {rel:.3e} "
          f"tol {TOL['train_loss_rel']:.0e}; element_acc card {acc_g:.4f} "
          f"cpu {acc_c:.4f}; launches {cstep_launches}", flush=True)
    if not (np.isfinite(got) and rel <= TOL["train_loss_rel"]):
        fail(f"classifier step loss differs: card {got}, cpu {ref}")
    # a probability within round-off of alpha may flip a few of the
    # B * S thresholded elements
    if abs(acc_g - acc_c) > 4 / (BATCH * cfg.num_speakers):
        fail(f"classifier step element_acc differs: {acc_g} vs {acc_c}")
    if {n: cstep_launches.get(n, 0) for n in ("lstm_fwd", "lstm_bwd")} != {
            "lstm_fwd": cfg.classifier_layers,
            "lstm_bwd": cfg.classifier_layers}:
        fail(f"classifier step launched {cstep_launches}")
    after_g, after_c = leaves(model), leaves(twin)
    worst, moved = 0.0, 0
    for name, ref in after_c.items():
        want, got = ref - before[name], after_g[name] - before[name]
        if not name.startswith("classifier."):
            if np.any(want) or np.any(got):
                fail(f"classifier step moved {name}")
            continue
        rel = float(np.linalg.norm(got - want) / np.linalg.norm(want))
        worst, moved = max(worst, rel), moved + 1
        if not rel <= TOL["train_update_rel"]:
            fail(f"classifier step update of {name}: rel L2 {rel}")
    print(f"classifier step updates: {moved} classifier leaves, worst rel L2 "
          f"{worst:.3e} tol {TOL['train_update_rel']:.0e}; the other "
          f"{len(after_c) - moved} leaves unmoved on both", flush=True)

    # ---- 7. trainer: run.train at full width -----------------------------
    from dl4ss_tpu_torch.run import train as train_cli
    from dl4ss_tpu_torch.train import loop as train_loop

    step_losses = []

    def recording(*args, **kwargs):
        fused = make_fused_step(*args, **kwargs)

        def run(state, bank_):
            state, metrics = fused(state, bank_)
            step_losses.append(float(metrics["loss"]))
            return state, metrics
        return run

    train_loop.make_fused_step = recording
    with tempfile.TemporaryDirectory() as tmp:
        metrics_path = os.path.join(tmp, "metrics.jsonl")
        torch.cuda.synchronize()
        cuda_lib.LAUNCHES.clear()
        k2.BODY_LAUNCHES.clear()
        state = train_cli.main([
            "--preset", "torch_multi", "--epochs", "1", "--epoch-size",
            str(TRAIN_STEPS), "--utts", str(BANK_UTTS), "--seed", str(SEED),
            "--metrics", metrics_path, "--device", "cuda"])
        torch.cuda.synchronize()
        train_launches = dict(cuda_lib.LAUNCHES)
        with open(metrics_path) as fh:
            record = json.loads(fh.read().splitlines()[-1])
    train_loop.make_fused_step = make_fused_step
    print(f"trainer: {TRAIN_STEPS} steps + eval, losses {step_losses}, eval "
          f"SI-SDR {record.get('si_sdr')} dB, launches {train_launches}",
          flush=True)
    if len(step_losses) != TRAIN_STEPS or not np.isfinite(step_losses).all():
        fail(f"trainer losses {step_losses}")
    if not np.isfinite(record.get("si_sdr", np.nan)):
        fail(f"trainer eval SI-SDR {record.get('si_sdr')}")
    missing = [n for n in cuda_lib.TRAINING_KERNELS
               if not train_launches.get(n)]
    if missing:
        fail(f"kernels never launched on the training path: {missing}")
    launches.update({n: train_launches[n] for n in ("gru_bwd",
                                                     "maskhead_bwd")})

    # each step runs the two encoder layers backward: K5 twice
    if train_launches["gru_bwd"] != cfg.encoder_layers * TRAIN_STEPS:
        fail(f"trainer launched gru_bwd {train_launches['gru_bwd']} times")
    for name in ("gru_fwd", "gru_bwd"):
        check_chain_bodies("trainer", name, train_launches[name])
    # one step in steady state: the step before it updated W, so K3 packs
    # the new version once
    fused = make_fused_step(cfg)
    fused(state, bank)
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    fused(state, bank)
    torch.cuda.synchronize()
    print(f"launches per train step: {dict(cuda_lib.LAUNCHES)}", flush=True)
    # the step's K3 and K6 share the one pack of the W the last step made
    got = {n: cuda_lib.LAUNCHES[n]
           for n in ("maskhead_pack", "maskhead_fwd", "maskhead_bwd")}
    if got != {"maskhead_pack": 1, "maskhead_fwd": 1, "maskhead_bwd": 1}:
        fail(f"a joint step launched {got}: expected one W pack, one K3 "
             f"and one K6")
    if train_launches["maskhead_bwd"] != TRAIN_STEPS:
        fail(f"trainer launched K6 {train_launches['maskhead_bwd']} times")

    # the classifier trainer: run.classify at full width, then its report
    from dl4ss_tpu_torch.run import classify as classify_cli

    closses = []

    def recording_classifier(*args, **kwargs):
        inner = make_classifier_step(*args, **kwargs)

        def run(state_, feats_):
            state_, metrics = inner(state_, feats_)
            closses.append(float(metrics["loss"]))
            return state_, metrics
        return run

    train_loop.make_classifier_step = recording_classifier
    printed = io.StringIO()
    torch.cuda.synchronize()
    cuda_lib.LAUNCHES.clear()
    k2.BODY_LAUNCHES.clear()
    try:
        with contextlib.redirect_stdout(printed):
            report = classify_cli.main([
                "--preset", "torch_multi", "--epochs", "1", "--epoch-size",
                str(CLASSIFY_STEPS), "--eval-batches", str(EVAL_BATCHES),
                "--utts", str(BANK_UTTS), "--seed", str(SEED), "--device",
                "cuda"])
    finally:
        train_loop.make_classifier_step = make_classifier_step
    torch.cuda.synchronize()
    classify_launches = dict(cuda_lib.LAUNCHES)
    print(printed.getvalue(), end="", flush=True)
    print(f"classifier trainer: {CLASSIFY_STEPS} steps + {EVAL_BATCHES} "
          f"report batches, losses {closses}, launches {classify_launches}",
          flush=True)
    if len(closses) != CLASSIFY_STEPS or not np.isfinite(closses).all():
        fail(f"classifier trainer losses {closses}")
    if "top3_recall:" not in printed.getvalue() or not np.isfinite(
            list(report.values())).all():
        fail(f"classifier trainer report {report}")
    # each step featurizes the mixture and its sources (K1 twice) and runs
    # the two classifier layers forward (K7) and backward (K8); each report
    # batch featurizes and runs them forward
    want = {"stft_features": 2 * (CLASSIFY_STEPS + EVAL_BATCHES),
            "lstm_fwd": cfg.classifier_layers * (CLASSIFY_STEPS
                                                 + EVAL_BATCHES),
            "lstm_bwd": cfg.classifier_layers * CLASSIFY_STEPS}
    got = {n: classify_launches.get(n, 0)
           for n in cuda_lib.CLASSIFIER_KERNELS}
    if got != want:
        fail(f"classifier trainer launched {got}, expected {want}")
    launches["lstm_bwd"] = classify_launches["lstm_bwd"]
    for name in ("lstm_fwd", "lstm_bwd"):
        check_chain_bodies("classifier trainer", name, classify_launches[name])

    for _ in range(2):      # the second step's launches
        torch.cuda.synchronize()
        cuda_lib.LAUNCHES.clear()
        cstep(state, featurize(sample_mixtures(state.generator, bank, cfg),
                               cfg))
    torch.cuda.synchronize()
    print(f"launches per classifier train step: {dict(cuda_lib.LAUNCHES)}",
          flush=True)

    # ---- 8. kernel timings --------------------------------------------------
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
            # as the kernel, on the padded signal; it yields X but no |X|
            library=lambda: torch.stft(xpad, L, hop, window=hann,
                                       center=False, return_complex=True),
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

    def time_row(name, r, kernel_iters, plain_iters):
        """Hold one kernel against its plain version, time both and its
        library yardstick, print them beside the bound and add the
        kernel's JSON row."""
        err = hold(f"{name} B={B} f32", r["kernel"](), r["plain"](),
                   TOL[name], rel=name.endswith("_bwd"))
        ms = device_ms(torch, r["kernel"], kernel_iters)
        plain_ms = device_ms(torch, r["plain"], plain_iters)
        lib_ms = (device_ms(torch, r["library"], 10)
                  if r["library"] else None)
        bound_ms, bound_by = bound(r["bytes"], r["t_ops"])
        kernels.append(dict(
            name=name, route="cuda", source=r["source"],
            replaces=r["replaces"], launches=launches[name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
            bound_by=bound_by, library_ms=lib_ms))
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
              f"ms, library {lib_ms} ms, bound {bound_ms:.4f} ms "
              f"({bound_by})", flush=True)

    def stft_extras():
        """K1 and K9 beside the rows: what a launch costs at all, the
        yardstick as it was timed before (padding inside), the direct body
        at the same shape, and both bodies by batch (B=1: a request; 2*B:
        the source signals of a train step)."""
        one = torch.zeros(1, device=dev)
        empty_ms = device_ms(torch, lambda: None, 50)
        add_ms = device_ms(torch, lambda: one.add_(1), 50)
        print(f"time launch floor: an event pair around nothing "
              f"{empty_ms:.4f} ms, around a one-element add {add_ms:.4f} ms",
              flush=True)
        old_lib = device_ms(torch, lambda: torch.stft(
            wav, L, hop, window=hann, center=True, pad_mode="reflect",
            return_complex=True), 20)
        print(f"time torch.stft(wav, center=True), the yardstick as timed "
              f"before (it pads inside): {old_lib:.4f} ms", flush=True)
        def k1(x, plain=False, **kw):
            return (k14.stft_features_plain if plain else
                    k14.stft_features_cuda)(x, L, hop, cfg.window,
                                            torch.float32, **kw)

        def k9(x, plain=False, **kw):
            return (k14.stft_ri_plain if plain else k14.stft_ri_cuda)(
                x, L, hop, cfg.window, **kw)

        hold("stft_ri FFT body against its plain torch mirror", k9(xpad),
             k14.stft_fft_mirror(xpad, L, hop, cfg.window), TOL["stft_mirror"])
        hold("stft_ri uncentered", k9(wav), k9(wav, plain=True),
             TOL["stft_ri"])
        for name, fn in (("stft_features", k1), ("stft_ri", k9)):
            for label, x in ((f"B={B}", xpad), ("B=1", xpad[:1].contiguous()),
                             (f"B={2 * B}", torch.cat([xpad, xpad]))):
                ref = fn(x, plain=True)
                for what, kw in (("FFT", {}), ("direct", {
                        "body": k14.BODY_DIRECT})):
                    hold(f"{name} {label} {what} body", fn(x, **kw), ref,
                         TOL[name])
                parts = [
                    f"{what} {device_ms(torch, lambda: fn(x, **kw), 50):.4f}"
                    for what, kw in (("FFT body", {}), (
                        "direct body", {"body": k14.BODY_DIRECT}))]
                lib = device_ms(torch, lambda: torch.stft(
                    x, L, hop, window=hann, center=False,
                    return_complex=True), 50)
                print(f"time {name} {label} ms: " + ", ".join(parts)
                      + f", torch.stft(center=False) {lib:.4f}", flush=True)

    def istft_extras():
        """K4 and K10 beside their rows (which time the rule's body, the FFT
        one): both bodies at B=16 and B=1, K4 also with bf16 masks, beside
        torch.istft on the same (masked) spectra."""
        rows_ = [("masked_istft", label, args[2].float() * args[0][:, None],
                  args[2].float() * args[1][:, None],
                  lambda kw, a=args: k14.masked_ola_cuda(*a, **kw),
                  k14.masked_ola_plain(*args),
                  k14.istft_fft_mirror(*args[:2], L, hop, cfg.window, args[2]))
                 for label, args in k4_cases.items()]
        for label, x in ((f"B={B}", ri_c), ("B=1", ri_c[:1].contiguous())):
            rows_.append(("istft_ri", label, x[..., :F], x[..., F:],
                          lambda kw, x=x: k14.istft_ola_cuda(
                              x, L, hop, cfg.window, **kw),
                          k14.istft_ola_plain(x, L, hop, cfg.window),
                          k14.istft_fft_mirror(x[..., :F], x[..., F:], L,
                                               hop, cfg.window)))
        for name, label, lre, lim, fn, ref, mirror in rows_:
            hold(f"{name} {label} FFT body against its plain torch mirror",
                 fn({}), mirror, TOL["istft_mirror"])
            for what, kw in (("FFT", {}), ("direct", {
                    "body": k14.BODY_DIRECT})):
                hold(f"{name} {label} {what} body", fn(kw), ref, TOL[name])
            parts = [f"{what} {device_ms(torch, lambda: fn(kw), 50):.4f}"
                     for what, kw in (("FFT body", {}), (
                         "direct body", {"body": k14.BODY_DIRECT}))]
            sc = torch.complex(lre, lim).reshape(-1, T, F).transpose(1, 2)
            sc = sc.contiguous()
            lib = device_ms(torch, lambda: torch.istft(
                sc, L, hop, window=hann, center=True, length=N_SAMPLES), 20)
            print(f"time {name} {label} ms: " + ", ".join(parts)
                  + f", torch.istft {lib:.4f}", flush=True)

    with torch.inference_mode():
        for name, r in rows.items():
            slow = name == "gru_fwd"
            time_row(name, r, 5 if slow else 20, 3 if slow else 10)
        stft_extras()
        istft_extras()
        for label, args in ((f"B={B} bf16 masks",
                             (*k3_args[:6], torch.bfloat16)),
                            ("B=1 f32 masks", (hb[:1], wb, bias, qb[:1], F, E,
                                               torch.float32)),
                            ("B=1 bf16 masks", (hb[:1], wb, bias, qb[:1], F,
                                                E, torch.bfloat16))):
            hold(f"maskhead_fwd {label}", k3.fused_dot_masks_cuda(*args),
                 k3.fused_dot_masks_plain(*args), TOL["maskhead_fwd"])
        if not torch.equal(k3.pack_w(wb, F, E), k3.pack_w_mirror(wb, F, E)):
            fail("K3's packed W differs from pack_w_mirror")
        pack_ms = device_ms(torch, lambda: k3.pack_w(wb, F, E), 10)
        print(f"time maskhead_pack (K3's W layout, once per weight version, "
              f"bf16 W): {pack_ms:.4f} ms", flush=True)
        # the B=1 request's kernels alone, at its own shapes
        x1 = reflect_pad(reqs[0][0], L // 2).contiguous()
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
        k3_b1_ms = device_ms(torch, one["maskhead_fwd"], 20)
        k3_b1_bound, k3_b1_by = bound(
            2 * (T * d2 + wb.numel() + K * E) + 4 * (bias.numel() + K * T * F),
            2 * T * d2 * F * E / BF16_TC_FLOPS
            + (2 * T * F * E + 2 * K * T * F * E + 4 * K * T * F) / F32_FLOPS)
        print(f"time maskhead_fwd B=1: kernel {k3_b1_ms:.4f} ms, bound "
              f"{k3_b1_bound:.4f} ms ({k3_b1_by})", flush=True)

    # the training kernels: K5 per layer (f32, as torch_multi trains; the
    # cuDNN yardstick is nn.GRU's backward) and K6
    gru_x = torch.randn((B, T, d2), device=dev, requires_grad=True)
    gru_out, _ = gru(gru_x)
    gru_dout = torch.randn_like(gru_out)
    gru_leaves = [gru_x, *gru.parameters()]
    x5, w5, b5, hp5, g5 = k5_args["f32"]
    train_rows = {
        "gru_bwd": dict(
            source="dl4ss_tpu_torch/csrc/gru_bwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:164",
            kernel=lambda: k2.gru_scan_bwd_cuda(*k5_args["f32"]),
            plain=lambda: k2.gru_scan_bwd_plain(*k5_args["f32"]),
            library=lambda: torch.autograd.grad(gru_out, gru_leaves,
                                                gru_dout, retain_graph=True),
            # xp, hprev, dhs, U, b_n in; dxp, dU, db_n out. Per row and
            # step three products of 2*H*3H (the gate recompute, the carry
            # and dU) and ~30 element operations per unit
            bytes=4 * (2 * x5.numel() + hp5.numel() + g5.numel()
                       + 2 * w5.numel() + 2 * b5.numel()),
            t_ops=T * D * B * (3 * 2 * H * 3 * H + 30 * H) / F32_FLOPS),
        "maskhead_bwd": dict(
            source="dl4ss_tpu_torch/csrc/maskhead_bwd.cu",
            replaces="dl4ss_tpu/ops/pallas_maskhead.py:186",
            kernel=lambda: k3.fused_dot_masks_bwd_cuda(*k6_args),
            plain=lambda: k3.fused_dot_masks_bwd_plain(*k6_args),
            library=None,
            # h, W, q, masks, dout (bf16) and the bias in; dacc (bf16), dq
            # and db out. The recomputed projection on the tensor cores; per
            # (b, t, f, e) the tanh and bias, dg (2K), dacc (3), the dq
            # column sums (2K) and db's (1); per (b, k, t, f) de (3)
            bytes=2 * (hb.numel() + wb.numel() + qb.numel() + masks6.numel()
                       + dout6.numel() + dacc.numel())
            + 4 * (bias.numel() + dq.numel() + db.numel()),
            t_ops=2 * B * T * d2 * F * E / BF16_TC_FLOPS
            + ((4 * K + 6) * B * T * F * E + 3 * B * K * T * F) / F32_FLOPS),
    }
    for name, r in train_rows.items():
        slow = name == "gru_bwd"
        time_row(name, r, 5 if slow else 20, 2 if slow else 5)
    # K6's dW and dh (a yardstick row, not a kernel: cuBLAS products that
    # JAX also leaves to XLA) both ways: bf16 operands with f32 output, as
    # the port runs them, and the f32 products of the upcast operands, as
    # the parent did. Bound: h, dacc and W in bf16, dW and dh out in f32;
    # two products of 2*B*T*D*F*E on the bf16 tensor cores
    dp_err = hold("dW + dh: bf16 operands, f32 output, against the f32 "
                  "products", k3.dacc_products(hb, wb, dacc),
                  k3.dacc_products_plain(hb, wb, dacc), TOL["dacc_products"],
                  rel=True)
    dp_ms = device_ms(torch, lambda: k3.dacc_products(hb, wb, dacc), 20)
    dp_f32_ms = device_ms(torch, lambda: k3.dacc_products_plain(hb, wb, dacc),
                          5)
    dp_bound, dp_by = bound(
        2 * (hb.numel() + dacc.numel() + wb.numel())
        + 4 * (wb.numel() + hb.numel()),
        2 * 2 * B * T * d2 * F * E / BF16_TC_FLOPS)
    kernels.append(dict(
        name="dacc_products", yardstick=True, route="cuda",
        source="dl4ss_tpu_torch/ops/maskhead_kernels.py",
        replaces="dl4ss_tpu/ops/pallas_maskhead.py:280",
        # one call per K6 launch of the trainer run
        launches=launches["maskhead_bwd"], max_abs_err=dp_err, ms=dp_ms,
        plain_ms=dp_f32_ms,
        bound_ms=dp_bound, bound_by=dp_by, library_ms=None))
    print(f"time dW + dh (yardstick, not a kernel): bf16 operands with f32 "
          f"output {dp_ms:.4f} ms, f32 products of the upcast operands "
          f"{dp_f32_ms:.4f} ms, bound {dp_bound:.4f} ms ({dp_by})",
          flush=True)

    def bwd_extras(name, cuda, plain, outs, args_by_label):
        """K5 or K8 beside its row (which times the rule's body): at every
        shape (bf16, B=32 and 128, H=600 stepwise only) both bodies held
        against the plain version (`check_bodies_on`) and re-measured in
        the same run, the rule's body named."""
        for label, args in args_by_label.items():
            bf16 = "_bf16" if args[0].dtype == torch.bfloat16 else ""
            check_bodies_on(torch, f"{name} {label}", name, cuda, plain,
                            args, outs, TOL[name + bf16], rel=True)
            parts = []
            hidden, batch = args[1].shape[1], args[0].shape[2]
            for body in (k2.BODY_RESIDENT, k2.BODY_STEPWISE):
                if (body == k2.BODY_STEPWISE
                        or hidden <= k2.RESIDENT_MAX_HIDDEN):
                    ms = device_ms(torch, lambda: cuda(*args, body=body),
                                   5 if batch <= BATCH else 3)
                    parts.append(f"{body} body {ms:.4f}")
            rule = k2.rnn_body(hidden, batch, sms=SMS, backward=True)
            print(f"time {name} {label} per layer ms: " + ", ".join(parts)
                  + f" (rule: {rule})", flush=True)

    bwd_extras("gru_bwd", k2.gru_scan_bwd_cuda, k2.gru_scan_bwd_plain,
               ("dxp", "dU", "db_n"), k5_args)
    # the kernels of the classifier path and the packed DSP pair. K7 and K8
    # per layer in f32, as torch_multi runs them; the cuDNN yardstick is one
    # bidirectional nn.LSTM layer (it includes its input projection, and
    # its backward the weight and input gradients)
    lstm = torch.nn.LSTM(d2, H, batch_first=True, bidirectional=True).to(dev)
    lstm_x = torch.randn((B, T, d2), device=dev, requires_grad=True)
    lstm_out, _ = lstm(lstm_x)
    lstm_dout = torch.randn_like(lstm_out)
    lstm_leaves = [lstm_x, *lstm.parameters()]
    x8, w8, hp8, cp8, cs8, g8 = k8_args["f32"]
    spec_c = torch.complex(ri_c[..., :F], ri_c[..., F:]).transpose(
        1, 2).contiguous()
    out_len = (T - 1) * hop + L
    new_rows = {
        "lstm_fwd": dict(
            source="dl4ss_tpu_torch/csrc/lstm_fwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:257",
            kernel=lambda: k2.lstm_scan_cuda(x7, w7),
            plain=lambda: k2.lstm_scan_plain(x7, w7),
            library=lambda: lstm(lstm_x.detach()),
            # xp and U in, hs and cs out; per row and step one product of
            # 2*H*4H and ~25 element operations per unit
            bytes=4 * (x7.numel() + w7.numel() + 2 * T * D * B * H),
            t_ops=T * D * B * (2 * H * 4 * H + 25 * H) / F32_FLOPS),
        "lstm_bwd": dict(
            source="dl4ss_tpu_torch/csrc/lstm_bwd.cu",
            replaces="dl4ss_tpu/ops/pallas_rnn.py:316",
            kernel=lambda: k2.lstm_scan_bwd_cuda(*k8_args["f32"]),
            plain=lambda: k2.lstm_scan_bwd_plain(*k8_args["f32"]),
            library=lambda: torch.autograd.grad(lstm_out, lstm_leaves,
                                                lstm_dout, retain_graph=True),
            # xp, hprev, cprev, cs, dhs and U in; dxp and dU out. Per row
            # and step three products of 2*H*4H (the gate recompute, the
            # carry and dU) and ~45 element operations per unit
            bytes=4 * (2 * x8.numel() + hp8.numel() + cp8.numel()
                       + cs8.numel() + g8.numel() + 2 * w8.numel()),
            t_ops=T * D * B * (3 * 2 * H * 4 * H + 45 * H) / F32_FLOPS),
        "stft_ri": dict(
            source="dl4ss_tpu_torch/csrc/stft_ri.cu",
            replaces="dl4ss_tpu/ops/pallas_stft.py:34",
            kernel=lambda: k14.stft_ri_cuda(xpad, L, hop, cfg.window),
            plain=lambda: k14.stft_ri_plain(xpad, L, hop, cfg.window),
            library=lambda: torch.stft(xpad, L, hop, window=hann,
                                       center=False, return_complex=True),
            # the padded wav in, [Re | Im] out; window: L multiplies
            bytes=4 * (xpad.numel() + ri_c.numel()),
            t_ops=(rfft_flops(B * T, L) + B * T * L) / F32_FLOPS),
        "istft_ri": dict(
            source="dl4ss_tpu_torch/csrc/istft_ri.cu",
            replaces="dl4ss_tpu/ops/pallas_stft.py:316",
            kernel=lambda: k14.istft_ola_cuda(ri_c, L, hop, cfg.window),
            plain=lambda: k14.istft_ola_plain(ri_c, L, hop, cfg.window),
            library=lambda: torch.istft(spec_c, L, hop, window=hann,
                                        center=True, length=N_SAMPLES),
            # [Re | Im] in, the overlap-added frames out; window and
            # overlap-add: 2 per sample
            bytes=4 * (ri_c.numel() + B * out_len),
            t_ops=(rfft_flops(B * T, L) + 2 * B * T * L) / F32_FLOPS),
    }
    for name, r in new_rows.items():
        slow = name.startswith("lstm")
        time_row(name, r, 5 if slow else 20,
                 (2 if name == "lstm_bwd" else 3) if slow else 10)
    def fwd_sweep():
        """K2 and K7 per layer, the resident, stepwise, (up to B=32)
        cluster and (from B=32) tiled bodies, by batch at H=300 up to the
        bulk serving batch B=256 (f32; bf16 at B=1 and 16), beside the body
        the rule names and the card's occupancy answer for the cluster
        body's two tilings: the numbers the forward's RESIDENT_MAX_CHUNKS,
        CLUSTER_UNITS and TILED_FROM follow; the rows at B=32 are the
        crossover of the resident and tiled bodies, B=48, 49 and 56 around
        that of K7's stepwise and tiled bodies. K7 also at H=600 in
        its wide and stepwise bodies at B=1, 16, 32 and 48, the numbers
        WIDE_MAX_BATCH follows; B=1 and 16 go on K7's row of the `kernels`
        line as `h600_ms`. Each body is held against the plain version
        first (`check_bodies_on`) up to B=32 and at B=256, and at H=600 at
        B=16. B=256 goes on K2 and K7's rows of the `kernels` line as
        `b256_ms`, by body."""
        sc = 1.0 / np.sqrt(H)
        for name in ("gru_fwd", "lstm_fwd"):
            for dt in (torch.float32, torch.bfloat16):
                fits = dict(k2.forward_clusters(dev, name, dt, H))
                print(f"occupancy {name} {dt} H={H}: clusters the card "
                      f"holds at once, by units a block (blocks a cluster "
                      + ", ".join(f"{-(-H // u)}" for u in fits)
                      + f"): {fits}", flush=True)
        for name, gates, fn, plain, outs in (
                ("gru_fwd", 3, k2.gru_scan_cuda, k2.gru_scan_plain, ("hs",)),
                ("lstm_fwd", 4, k2.lstm_scan_cuda, k2.lstm_scan_plain,
                 ("hs", "cs"))):
            w = tensor(rng.uniform(-sc, sc, (2, H, gates * H)))
            row = next(r for r in kernels if r["name"] == name)
            for batch in (1, BATCH, 2 * BATCH, 3 * BATCH, 3 * BATCH + 1,
                          7 * BATCH // 2, 4 * BATCH, 6 * BATCH, 8 * BATCH,
                          16 * BATCH):
                x = tensor(0.5 * rng.standard_normal((T, 2, batch,
                                                      gates * H)))
                dts = ((torch.float32, torch.bfloat16) if batch <= BATCH
                       else (torch.float32,))
                for dt in dts:
                    xd, wd = x.to(dt), w.to(dt)
                    args = (xd, wd, bhn) if gates == 3 else (xd, wd)
                    label = "bf16" if dt == torch.bfloat16 else "f32"
                    if batch <= 2 * BATCH or batch == 16 * BATCH:
                        check_bodies_on(
                            torch, f"{name} B={batch} {label}", name, fn,
                            plain, args, outs, TOL[name if label == "f32"
                                                   else name + "_bf16"],
                            rel=False)
                    parts = []
                    bodies = (k2.BODY_RESIDENT, k2.BODY_STEPWISE) + (
                        (k2.BODY_CLUSTER,) if batch <= 2 * BATCH else ()) + (
                        (k2.BODY_TILED,) if batch >= 2 * BATCH else ())
                    ms = {}
                    for body in bodies:
                        ms[body] = device_ms(
                            torch, lambda: fn(*args, body=body),
                            5 if batch <= 2 * BATCH else 3)
                        parts.append(f"{body} {ms[body]:.4f}")
                    if batch == 16 * BATCH:
                        row["b256_ms"] = ms
                    rule = k2.default_body(dev, name, dt, H, batch)
                    units = k2.cluster_units(H, batch, 2, k2.forward_clusters(
                        dev, name, dt, H))
                    print(f"time {name} B={batch} {label} per layer ms: "
                          + ", ".join(parts) + f" (rule: {rule}"
                          + (f", {units} units a block" if units else "")
                          + ")", flush=True)
                del x
        sc = 1.0 / np.sqrt(WIDE)
        w = tensor(rng.uniform(-sc, sc, (2, WIDE, 4 * WIDE)))
        row = next(r for r in kernels if r["name"] == "lstm_fwd")
        row["h600_ms"] = {}
        for batch in (1, BATCH, 2 * BATCH, 3 * BATCH):
            x = tensor(0.5 * rng.standard_normal((T, 2, batch, 4 * WIDE)))
            if batch == BATCH:
                check_bodies_on(torch, f"lstm_fwd H={WIDE} B={batch}",
                                "lstm_fwd", k2.lstm_scan_cuda,
                                k2.lstm_scan_plain, (x, w), ("hs", "cs"),
                                TOL["lstm_fwd"], rel=False)
            ms = {body: device_ms(torch, lambda: k2.lstm_scan_cuda(
                      x, w, body=body), 5 if batch <= BATCH else 3)
                  for body in (k2.BODY_WIDE, k2.BODY_STEPWISE)}
            if batch in (1, BATCH):
                row["h600_ms"][f"B={batch}"] = ms
            print(f"time lstm_fwd f32 H={WIDE} B={batch} per layer ms: "
                  + ", ".join(f"{b} {v:.4f}" for b, v in ms.items())
                  + f" (rule: {k2.rnn_body(WIDE, batch, sms=SMS)})",
                  flush=True)
            del x

    with torch.inference_mode():
        fwd_sweep()
    bwd_extras("lstm_bwd", k2.lstm_scan_bwd_cuda, k2.lstm_scan_bwd_plain,
               ("dxp", "dU"), k8_args)
    with tempfile.TemporaryDirectory() as tmp:
        # ---- 9. persistence ----------------------------------------------
        persistence_phase(torch, dev, rng, tmp)
        # ---- 10. TDAA at full width ----------------------------------------
        tdaa_launches = tdaa_phase(torch, dev, rng, wav, reqs)
        # ---- 11. the learning check ----------------------------------------
        learning_phase(torch, tmp)
        # ---- 12. data sources and scoring --------------------------------
        data_launches = data_phase(torch, dev, tmp, SMOKE_DATA)
        # ---- 13. the memory, image-query and video generations ----------
        gen_launches = generations_phase(torch, dev, tmp)
        # ---- 14. parallel and utils --------------------------------------
        par_launches = parallel_phase(torch, dev, tmp)
    # ---- 15. the public surface ---------------------------------------------
    surface_kernels, _ = surface_phase(torch, dev, smi)

    for row in kernels:
        # the kernel's launches on the tdaa paths (phase 10), beside those
        # of the torch_multi paths in `launches` (the dW + dh products run
        # once per K6 launch)
        name = "maskhead_bwd" if row.get("yardstick") else row["name"]
        row["tdaa_launches"] = tdaa_launches.get(name, 0)
        # and on the data-source paths (phase 12)
        row["data_launches"] = data_launches.get(name, 0)
        # and on the generations' CLI runs (phase 13)
        row["gen_launches"] = gen_launches.get(name, 0)
        # and on the parallel paths (phase 14: --dp auto, both dp=2 ranks)
        row["par_launches"] = par_launches.get(name, 0)
    # the D = 1 rows (phase 15): their launches are the one-direction
    # stacks' of phase 15 alone
    kernels += surface_kernels
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
