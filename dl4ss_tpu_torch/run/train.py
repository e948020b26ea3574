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

Trains on the synthetic bank (--utts utterances per speaker) with the
preset's loss and clipped Adam, and prints one JSON line per epoch with the
last step's losses and the held-out SI-SDR. `--checkpoint-dir` saves the
state there (with a `cfg.json` sidecar); `--resume` goes on from its latest
step under the sidecar's config; `--init-from DIR` warm-starts from another
run's parameters with a fresh optimizer. Not ported yet, each exiting with
a one-line message: the memory, video and image-query modes (ROADMAP P12)
and --data-root (P10).
"""

from __future__ import annotations

import argparse

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.run.common import (add_common_args, apply_overrides,
                                        build_cfg, load_bank)
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
    args = p.parse_args(argv)

    if args.mode in ("memory", "video", "image-query"):
        raise SystemExit(f"--mode {args.mode} is not ported yet (ROADMAP "
                         f"P12)")
    if args.dis_sp and args.mode != "adversarial":
        raise SystemExit("--dis-sp only applies to --mode adversarial")
    if args.init_from and args.resume:
        raise SystemExit("--init-from (warm start, fresh optimizer) and "
                         "--resume (exact state restore) conflict; pick one")
    cfg = build_cfg(args)
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
    bank = load_bank(cfg, args, device)
    print(cfg.log_config())
    try:
        state, sdr = train_loop(
            cfg, bank=bank, max_epochs=args.epochs,
            epoch_size=args.epoch_size, seed=args.seed, mode=args.mode,
            metrics_path=args.metrics, checkpoint_dir=args.checkpoint_dir,
            resume=args.resume, eval_every=args.eval_every,
            init_from=args.init_from, dis_sp=args.dis_sp, device=device)
    except ValueError as err:
        if args.init_from and "do not match the model" in str(err):
            raise SystemExit(f"--init-from: {err}") from None
        raise
    if sdr:
        print(f"final SI-SDR: {sdr[-1]:.2f} dB (best {max(sdr):.2f})")
    return state


if __name__ == "__main__":
    main()
