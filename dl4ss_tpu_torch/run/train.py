"""Training CLI — the port of `dl4ss_tpu/run/train.py`, joint and
classifier modes:

    python -m dl4ss_tpu_torch.run.train --preset torch_multi --epochs 10
    python -m dl4ss_tpu_torch.run.train --preset torch_multi \
        --mode classifier --epochs 10
    python -m dl4ss_tpu_torch.run.train --preset synth_tiny --device cpu \
        --epochs 1 --epoch-size 2 --metrics metrics.jsonl

Trains on the synthetic bank (--utts utterances per speaker) with the
preset's loss and clipped Adam, and prints one JSON line per epoch with the
last step's losses and the held-out SI-SDR. Not ported yet, each exiting
with a one-line message: the other modes (ROADMAP P9, P12),
--checkpoint-dir / --resume / --init-from (P7) and --data-root (P10).
"""

from __future__ import annotations

import argparse

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.run.common import add_common_args, build_cfg, load_bank
from dl4ss_tpu_torch.train.loop import train_loop


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--mode", default="joint",
                   choices=["joint", "dense", "adversarial", "classifier",
                            "memory", "video", "image-query"],
                   help="joint and classifier are ported; the others are "
                        "not yet")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch-size", type=int, default=None)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--init-from", default=None)
    p.add_argument("--eval-every", type=int, default=1)
    args = p.parse_args(argv)

    if args.mode not in ("joint", "classifier"):
        raise SystemExit(f"--mode {args.mode} is not ported yet (joint and "
                         f"classifier only; ROADMAP P9, P12)")
    if args.checkpoint_dir or args.resume or args.init_from:
        raise SystemExit("--checkpoint-dir / --resume / --init-from are not "
                         "ported yet (ROADMAP P7)")
    cfg = build_cfg(args)
    device = resolve_device(args.device)
    bank = load_bank(cfg, args, device)
    print(cfg.log_config())
    state, sdr = train_loop(
        cfg, bank=bank, max_epochs=args.epochs, epoch_size=args.epoch_size,
        seed=args.seed, mode=args.mode, metrics_path=args.metrics,
        eval_every=args.eval_every, device=device)
    if sdr:
        print(f"final SI-SDR: {sdr[-1]:.2f} dB (best {max(sdr):.2f})")
    return state


if __name__ == "__main__":
    main()
