"""Training CLI — the port of `dl4ss_tpu/run/train.py`, the joint, dense,
adversarial and classifier modes:

    python -m dl4ss_tpu_torch.run.train --preset torch_multi --epochs 10 \
        --checkpoint-dir ck
    python -m dl4ss_tpu_torch.run.train --preset torch_multi --epochs 20 \
        --checkpoint-dir ck --resume
    python -m dl4ss_tpu_torch.run.train --preset tdaa --mode adversarial
    python -m dl4ss_tpu_torch.run.train --preset tdaa --mode dense
    python -m dl4ss_tpu_torch.run.train --preset torch_multi \
        --mode classifier --epochs 10
    python -m dl4ss_tpu_torch.run.train --preset synth_tiny --device cpu \
        --epochs 1 --epoch-size 2 --metrics metrics.jsonl
    python -m dl4ss_tpu_torch.run.train --preset torch_multi \
        --data-root corpus/wsj0 --split si_tr_s --utts 100
    python -m dl4ss_tpu_torch.run.train --preset tdaa --mode adversarial \
        --dis-sp --list-dir corpus/lists --wav-root corpus --checkpoint-dir ck

Trains with the preset's loss and clipped Adam on the synthetic bank
(--utts utterances per speaker), on a speaker tree (--data-root, --split)
or on the official wsj0-mix lists (--list-dir, --wav-root, --mix-k pools;
an epoch is one pass over the lists, scored on the first cv batch), and
prints one JSON line per epoch with the last step's losses and the held-out
SI-SDR. `--noise-wavs DIR` mixes street noise into every training mixture
(bank mode). `--checkpoint-dir` saves the state there (with a `cfg.json`
sidecar, and the list vocabulary as `vocab.json`); `--resume` goes on from
its latest step under the sidecar's config; `--init-from DIR` warm-starts
from another run's parameters with a fresh optimizer. Not ported yet, each
exiting with a one-line message: the memory, video and image-query modes
and the Cocktail wavlists (--file-lists) (ROADMAP P12).
"""

from __future__ import annotations

import argparse
import os

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.run.common import (add_common_args, apply_overrides,
                                        build_cfg, load_bank,
                                        load_noise_bank, write_vocab)
from dl4ss_tpu_torch.train.checkpoint import load_cfg
from dl4ss_tpu_torch.train.loop import train_loop


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--mode", default="joint",
                   choices=["joint", "dense", "adversarial", "classifier",
                            "memory", "video", "image-query"],
                   help="dense = the all-speaker channel layout "
                        "(Torch_multi/main_run.py:473-506); adversarial = "
                        "TDAA's two-phase discriminator trainer; memory, "
                        "video and image-query are not ported yet")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch-size", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="go on from the latest step in --checkpoint-dir, "
                        "under the config it was trained with")
    p.add_argument("--init-from", default=None,
                   help="warm-start fine-tune: load the parameters of this "
                        "checkpoint dir into a FRESH optimizer")
    p.add_argument("--eval-every", type=int, default=1)
    p.add_argument("--dis-sp", action="store_true",
                   help="adversarial 'real' pool = same-speaker different "
                        "utterances (the dis-sp trainer, B10)")
    p.add_argument("--noise-wavs", default=None,
                   help="directory of background-noise wavs (A5 street "
                        "noise, bank mode)")
    p.add_argument("--list-dir", default=None,
                   help="official wsj0-mix list directory "
                        "(create-speaker-mixtures): train epoch-finite from "
                        "mix_{k}_spk_tr.txt, the reference's list recipe "
                        "(TDAA_beta/predata_fromList.py:80-233)")
    p.add_argument("--file-lists", default=None, metavar="DIR",
                   help="Cocktail wavlist directory of the memory mode "
                        "(not ported yet, ROADMAP P12)")
    p.add_argument("--wav-root", default=None,
                   help="root the list wav paths are relative to")
    p.add_argument("--mix-k", default="2",
                   help="mixture speaker count(s) of the lists, "
                        "comma-separated for mixed-k per-pool training "
                        "(e.g. 1,2,3, predata_fromList_123.py:45-110)")
    args = p.parse_args(argv)

    if args.mode in ("memory", "video", "image-query"):
        raise SystemExit(f"--mode {args.mode} is not ported yet (ROADMAP "
                         f"P12)")
    if args.file_lists:
        raise SystemExit("--file-lists (the Cocktail wavlists of the memory "
                         "mode) is not ported yet (ROADMAP P12); use "
                         "--list-dir or --data-root")
    if args.noise_wavs and args.list_dir:
        raise SystemExit(
            "--noise-wavs is the bank-mode street-noise augment "
            "(sample_mixtures, A5); the list-driven path mixes no noise: "
            "drop the flag or use bank mode")
    if args.dis_sp and args.mode != "adversarial":
        raise SystemExit("--dis-sp only applies to --mode adversarial")
    if args.init_from and args.resume:
        raise SystemExit("--init-from (warm start, fresh optimizer) and "
                         "--resume (exact state restore) conflict; pick one")
    cfg = build_cfg(args)
    ck_cfg = None
    if args.resume and args.checkpoint_dir:
        # resume rebuilds the state shapes the checkpoint was trained with;
        # the runtime overrides (--set, --batch-size) still win
        ck_cfg = load_cfg(args.checkpoint_dir)
        if ck_cfg is not None:
            cfg = apply_overrides(ck_cfg, args).validate()
            print(f"resuming under the checkpoint's config (preset "
                  f"{ck_cfg.name!r})")
    if args.mode == "adversarial":
        cfg = cfg.replace(use_discriminator=True)
    device = resolve_device(args.device)
    bank = sampler = eval_batch = noise_bank = None
    if args.list_dir:
        # the official list recipe; the dev batch comes from the cv list
        # under the TRAIN vocabulary
        from dl4ss_tpu_torch.data.listsampler import Wsj0MixSampler
        from dl4ss_tpu_torch.data.wsj0mix import mix_list_name
        root = args.wav_root or "."
        mix_ks = tuple(int(x) for x in str(args.mix_k).split(","))
        sampler = Wsj0MixSampler(args.list_dir, root, cfg, args.split,
                                 mix_ks=mix_ks, device=device)
        cfg = cfg.replace(num_speakers=sampler.num_speakers)
        if args.checkpoint_dir:
            # evaluators index the embedding rows through this vocabulary
            # (speaker -> row is an artifact of the TRAIN lists)
            write_vocab(args.checkpoint_dir, sampler.spk2idx)
        if any(os.path.exists(os.path.join(args.list_dir,
                                           mix_list_name(k, "valid")))
               for k in mix_ks):
            dev = Wsj0MixSampler(args.list_dir, root, cfg, "valid",
                                 mix_ks=mix_ks, spk2idx=sampler.spk2idx,
                                 device=device)
            if dev.num_batches(cfg.batch_size) >= 1:
                eval_batch = next(dev.batches(cfg.batch_size,
                                              shuffle=False))
    else:
        bank, cfg, _ = load_bank(cfg, args, device)
    if args.noise_wavs:
        noise_bank = load_noise_bank(args.noise_wavs, cfg, device)
        cfg = cfg.replace(add_bgd_noise=True)
    if ck_cfg is not None and cfg.num_speakers != ck_cfg.num_speakers:
        raise SystemExit(
            f"--resume: the data source has {cfg.num_speakers} speakers "
            f"but the checkpoint was trained with {ck_cfg.num_speakers}; "
            f"resume with the original data/lists")
    print(cfg.log_config())
    try:
        state, sdr = train_loop(
            cfg, bank=bank, max_epochs=args.epochs,
            epoch_size=args.epoch_size, seed=args.seed, mode=args.mode,
            metrics_path=args.metrics, checkpoint_dir=args.checkpoint_dir,
            resume=args.resume, eval_every=args.eval_every,
            init_from=args.init_from, dis_sp=args.dis_sp,
            noise_bank=noise_bank, sampler=sampler, eval_batch=eval_batch,
            device=device)
    except ValueError as err:
        if args.init_from and "do not match the model" in str(err):
            raise SystemExit(f"--init-from: {err}") from None
        raise
    if sdr:
        print(f"final SI-SDR: {sdr[-1]:.2f} dB (best {max(sdr):.2f})")
    return state


if __name__ == "__main__":
    main()
