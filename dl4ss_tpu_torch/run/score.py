"""Directory SDR scorer — the rebuild of `bss_test.cal` (the port of
`dl4ss_tpu/run/score.py`).

The reference scores every separation run by scanning `batch_output/` for
wavs following the naming contract and averaging permutation-resolved
BSS-Eval SDR over mixtures (Torch_multi/bss_test.py:12-61, called per epoch
from the drivers, e.g. main_run_multi_selfSS_recu.py:408-409):

  {idx}_{spk}_pre.wav       estimates
  {idx}_{spk}_realTrue.wav  references (raw clean sources; genTrue fallback)
  {idx}_True_mix.wav        the mixture (for NSDR)

Reproduced from cal():
  * estimates and references grouped by the leading index token
    (bss_test.py:13,25);
  * the 1-estimate / 2-reference repeat trick (bss_test.py:53-54);
  * optional silent-channel padding when there are MORE estimates than
    references: pad the references with near-silent channels, resolve the
    permutation over the padded problem, keep the best `aim` estimates and
    score them against the true references (bss_test.py:47-51);
  * the mean SDR over every (mixture, channel) pair (bss_test.py:59-60).

Unlike the reference's per-file CPU bss_eval_sources, the mixtures of one
channel count are stacked and scored in one batched call on the device
(`--chunk` mixtures at a time), the NSDR baselines too.

    python -m dl4ss_tpu_torch.run.score batch_output/ --nsdr
"""

from __future__ import annotations

import argparse
import os
import re
from collections import defaultdict

import numpy as np
import torch

from dl4ss_tpu_torch.data.wavio import read_wav
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.eval.bss_eval import bss_eval_sources

_NAME = re.compile(r"^(?P<idx>[^_]+)_(?P<rest>.+)\.wav$")


def collect_groups(path: str):
    """Scan a batch_output-style directory into {idx: {kind: [paths...]}}.

    Files are visited in sorted order (the reference's sorted listdir,
    bss_test.py:22), so the channel order is deterministic. Only names are
    collected here: the wavs are decoded per scoring chunk, so a
    3,000-mixture export never sits whole in host memory."""
    groups = defaultdict(lambda: defaultdict(list))
    for name in sorted(os.listdir(path)):
        m = _NAME.match(name)
        if not m:
            continue
        idx, rest = m.group("idx"), m.group("rest")
        if rest == "True_mix":
            kind = "mix"
        elif rest.endswith("_realTrue"):
            kind = "realTrue"
        elif rest.endswith("_genTrue"):
            kind = "genTrue"
        elif rest.endswith("_pre"):
            kind = "pre"
        else:
            continue
        groups[idx][kind].append(os.path.join(path, name))
    return groups


def _load(paths):
    out = []
    for p in paths:
        wav, _ = read_wav(p)
        if wav.ndim > 1:
            wav = wav[:, 0]
        out.append(wav.astype(np.float32))
    return out


def _stack(wavs, length):
    out = np.zeros((len(wavs), length), np.float32)
    for i, w in enumerate(wavs):
        out[i, :min(len(w), length)] = w[:length]
    return out


def score_dir(path: str, aim: int = 2, flen: int = 512,
              pad_silent: bool = False, with_nsdr: bool = False,
              verbose: bool = True, chunk: int = 200, device=None):
    """Score every mixture group in `path` on `device` (default `cuda`;
    raises without a GPU unless device='cpu'). Returns a dict with the
    flat SDR array (one entry per scored channel, the reference's
    SDR_sum), its mean, the per-mixture SDRs and, with `with_nsdr`, the
    mean NSDR."""
    dev = resolve_device(device)

    def bss(ref, est, permute=True):
        res = bss_eval_sources(torch.as_tensor(ref, device=dev),
                               torch.as_tensor(est, device=dev), flen=flen,
                               permute=permute)
        return res.sdr.cpu().numpy(), res.perm.cpu().numpy()

    groups = collect_groups(path)
    if verbose:
        print(f"num of mixed: {len(groups)}")

    # mixtures batched by (n_ref, n_est); only paths here, the wavs are
    # decoded per chunk below
    batches = defaultdict(list)
    for idx in sorted(groups, key=lambda s: (len(s), s)):
        g = groups[idx]
        ref_p = g["realTrue"] or g["genTrue"]
        est_p = g["pre"]
        if not ref_p or not est_p:
            continue
        k_ref, k_est = len(ref_p), len(est_p)
        if k_est == 1 and k_ref == 2:
            k_est = 2                              # bss_test.py:53-54 repeat
        batches[(k_ref, k_est)].append((idx, ref_p, est_p, g["mix"]))

    sdr_sum, nsdr_sum, per_mix = [], [], {}
    for (k_ref, k_est), items in sorted(batches.items()):
        if k_est > k_ref and pad_silent:
            # the silent-channel trick (bss_test.py:47-51): resolve the
            # permutation on the padded problem, then score the estimates
            # assigned to the true references. perm maps estimate j to
            # source perm[j], so the estimate chosen for source s is
            # argsort(perm)[s], not perm[s].
            for idx, ref_p, est_p, mix_p in items:
                refs, ests = _load(ref_p), _load(est_p)
                length = max(len(w) for w in refs + ests)
                ref, est = _stack(refs, length), _stack(ests, length)
                pad = np.zeros((k_est - k_ref, length), np.float32) + 1e-5
                _, perm = bss(np.concatenate([ref, pad]), est)
                chosen = est[np.argsort(perm)[:aim]]
                sdr, perm = bss(ref[:aim], chosen)
                mix = _stack(_load(mix_p), length) if mix_p else None
                _accumulate([idx], ref[None, :aim], sdr[None], perm[None],
                            [mix], bss, sdr_sum, nsdr_sum, per_mix,
                            with_nsdr)
            continue
        if k_est != k_ref:
            if verbose:
                for idx, *_ in items:
                    print(f"skip {idx}: {k_est} estimates vs {k_ref} "
                          f"references (rerun with --pad-silent)")
            continue
        # chunks bound the (K*flen)^2 systems on the device and the
        # decoded wavs on the host
        for lo in range(0, len(items), chunk):
            part = [(idx, _load(ref_p), _load(est_p),
                     _load(mix_p) if mix_p else None)
                    for idx, ref_p, est_p, mix_p in items[lo:lo + chunk]]
            length = max(len(w) for _, refs, ests, _ in part
                         for w in refs + ests)
            ref_s, est_s, mix_s = [], [], []
            for _, refs, ests, mixw in part:
                ref_s.append(_stack(refs, length))
                est = _stack(ests, length)
                if est.shape[0] == 1 and k_est == 2:
                    est = np.repeat(est, 2, axis=0)  # bss_test.py:53-54
                est_s.append(est)
                mix_s.append(_stack(mixw, length) if mixw else None)
            ref_s = np.stack(ref_s)
            sdr, perm = bss(ref_s, np.stack(est_s))
            _accumulate([x[0] for x in part], ref_s, sdr, perm, mix_s, bss,
                        sdr_sum, nsdr_sum, per_mix, with_nsdr)

    sdr_arr = np.concatenate(sdr_sum) if sdr_sum else np.array([])
    out = {"sdr": sdr_arr,
           "mean_sdr": float(sdr_arr.mean()) if sdr_arr.size else float("nan"),
           "per_mix": per_mix, "n_mixtures": len(per_mix)}
    if with_nsdr and nsdr_sum:
        out["mean_nsdr"] = float(np.concatenate(nsdr_sum).mean())
    if verbose:
        for idx in sorted(per_mix, key=lambda s: (len(s), s)):
            print(f"{idx}: SDR {np.array2string(per_mix[idx], precision=2)}")
        print(f"SDR here: {out['mean_sdr']:.4f}")
        if "mean_nsdr" in out:
            print(f"NSDR here: {out['mean_nsdr']:.4f}")
    return out


def _accumulate(idxs, ref, sdr, perm, mixes, bss, sdr_sum, nsdr_sum,
                per_mix, with_nsdr):
    """Record the SDRs of a stack of mixtures (ref (B, K, N), sdr / perm
    (B, K)) and, with `with_nsdr`, the NSDR of those with a mixture wav."""
    for i, idx in enumerate(idxs):
        sdr_sum.append(sdr[i])
        per_mix[idx] = sdr[i]
    have = [i for i, m in enumerate(mixes) if m is not None]
    if not with_nsdr or not have:
        return
    # NSDR = SDR(pred) - SDR(mixture-as-prediction) (BSS_EVAL.m:16-21);
    # sdr[j] scores estimate j against source perm[j], so the baseline is
    # gathered through the same assignment
    k = ref.shape[1]
    mix_rep = np.stack([np.repeat(mixes[i][:1], k, axis=0) for i in have])
    mix_sdr, _ = bss(ref[have], mix_rep, permute=False)
    for row, i in enumerate(have):
        nsdr_sum.append(sdr[i] - mix_sdr[row][perm[i]])


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("path", help="batch_output-style directory")
    p.add_argument("--aim", type=int, default=2,
                   help="aim_mix_number: channels kept under --pad-silent "
                        "(bss_test.py:9)")
    p.add_argument("--flen", type=int, default=512,
                   help="BSS-Eval projection filter taps")
    p.add_argument("--pad-silent", action="store_true",
                   help="silence-channel padding when estimates outnumber "
                        "references (bss_test.py:47-51)")
    p.add_argument("--nsdr", action="store_true",
                   help="also report NSDR vs the exported True_mix")
    p.add_argument("--chunk", type=int, default=200,
                   help="mixtures per batched BSS-Eval call")
    p.add_argument("--device", default="cuda",
                   help="torch device to score on: cuda (default; fails "
                        "without a GPU) or cpu")
    args = p.parse_args(argv)
    return score_dir(args.path, aim=args.aim, flen=args.flen,
                     pad_silent=args.pad_silent, with_nsdr=args.nsdr,
                     chunk=args.chunk, device=args.device)


if __name__ == "__main__":
    main()
