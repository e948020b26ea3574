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
from another run's parameters with a fresh optimizer.

    python -m dl4ss_tpu_torch.run.train --preset cocktail --mode memory \
        --epochs 20 --checkpoint-dir ck [--file-lists lists --wav-root .]
    python -m dl4ss_tpu_torch.run.train --preset multimodal_image \
        --mode image-query
    python -m dl4ss_tpu_torch.run.train --preset grid_video --mode video \
        [--video-trunk inception] [--video-root grid]

`--mode memory` trains the Cocktail target-speaker extractor with the
life-long speaker memory (voiceprint, image or lip-frame queries by
--query-source), early-stopped on the dev loss (--patience), keeping the
best parameters and memory, from the bank, a speaker tree or the Cocktail
train wavlist (--file-lists); it writes `vocab.json` beside its
checkpoint, and --resume / --init-from carry the memory. `--mode video` /
`image-query` train the separator on lip-frame (synthetic, or
--video-root) or digit-glyph queries; the Inception trunk is frozen.

    python -m dl4ss_tpu_torch.run.train --preset tdaa --mode tasnet \
        --set max_len_seconds=4 --batch-size 4 --set learning_rate=1e-3 \
        --set lr_schedule=constant --set grad_clip_norm=5

`--mode tasnet` trains DPRNN-TasNet (models/dprnn.py) at the paper's
widths on waveforms drawn from the bank, negative SI-SNR under uPIT, the
data and optimizer fields from the preset and its overrides (the model's
speakers are the preset's max_mix); it writes no checkpoint.

    python -m dl4ss_tpu_torch.run.train --preset synth_tiny --device cpu \
        --dp 2 --epochs 1 --epoch-size 2
    python -m dl4ss_tpu_torch.run.train --preset torch_multi --dp auto

`--dp N` / `--mp M` train on N x M ranks (data x model; the embedding
table row-sharded over the model axis when M divides its rows): this
process starts them, one card a rank over NCCL (gloo on the CPU), and
returns rank 0's final state, which equals the single-device run's.
`--dp auto` takes every visible card (divided by --mp), one on the CPU.
Under torchrun (WORLD_SIZE set) the ranks it started are used instead.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys

import torch
import torch.distributed as dist

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.run.common import (add_common_args, apply_overrides,
                                        build_cfg, frame_hw, load_bank,
                                        load_frame_bank, load_noise_bank,
                                        write_vocab)
from dl4ss_tpu_torch.train.checkpoint import load_cfg
from dl4ss_tpu_torch.train.loop import train_loop


_QUERY_MODES = ("memory", "video", "image-query")
_NOISE_REFUSAL = ("--noise-wavs is the bank-mode street-noise augment "
                  "(sample_mixtures, A5) — the list-driven and memory/query "
                  "paths do not mix noise; drop the flag or use bank mode")


def build_parser() -> argparse.ArgumentParser:
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--mode", default="joint",
                   choices=["joint", "dense", "adversarial", "classifier",
                            "memory", "video", "image-query", "tasnet"],
                   help="dense = the all-speaker channel layout "
                        "(Torch_multi/main_run.py:473-506); adversarial = "
                        "TDAA's two-phase discriminator trainer; memory = "
                        "Cocktail target extraction with the speaker "
                        "memory; video = GRID audio-visual query training "
                        "(main_run.py:226-256); image-query = "
                        "MNIST-digit-conditioned separation (Multi_modal); "
                        "tasnet = DPRNN-TasNet on waveforms "
                        "(arXiv:1910.06379)")
    p.add_argument("--query-source", default="speech",
                   choices=["speech", "image", "video"],
                   help="memory mode: voiceprint (Cocktail), MNIST digit "
                        "(Multi_modal), or lip-frame query written into "
                        "the memory's VIDEO slot (MEMORY.add_video, "
                        "Torch_multi/main_run.py:142-171)")
    p.add_argument("--video-root", default=None,
                   help="video queries: GRID-style speaker tree of lip "
                        "clips (root/<speaker>/<clip dir of frames or video "
                        "file>); synthetic speaker-keyed frames if omitted")
    p.add_argument("--frames", type=int, default=4,
                   help="video queries: frames per clip")
    p.add_argument("--frame-size", type=int, default=48,
                   help="video queries: square frame edge in pixels")
    p.add_argument("--frame-dtype", default="float32",
                   choices=["float32", "uint8"],
                   help="video queries: hold the lip-frame bank on the "
                        "device as float32, or as uint8 pixel values (a "
                        "quarter of the memory) normalized where the trunk "
                        "reads them")
    p.add_argument("--video-trunk", default="conv",
                   choices=["conv", "inception"],
                   help="video queries: per-frame feature trunk; "
                        "'inception' is the reference's frozen Inception-v3 "
                        "(299x299 frames)")
    p.add_argument("--patience", type=int, default=10,
                   help="memory mode: dev-loss early-stop patience "
                        "(nnet.py:159-172)")
    p.add_argument("--epochs", type=int, default=None)
    p.add_argument("--epoch-size", type=int, default=None)
    p.add_argument("--resume", action="store_true",
                   help="go on from the latest step in --checkpoint-dir, "
                        "under the config it was trained with")
    p.add_argument("--init-from", default=None,
                   help="warm-start fine-tune: load the parameters (and, in "
                        "memory mode, the speaker memory) of this "
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
                   help="memory mode: Cocktail wavlist directory "
                        "(generate_file_lists output); the training bank "
                        "is built from train_wavlist.txt's `wav spk` rows "
                        "(prepare_data.py:104-155)")
    p.add_argument("--wav-root", default=None,
                   help="root the list wav paths are relative to")
    p.add_argument("--mix-k", default="2",
                   help="mixture speaker count(s) of the lists, "
                        "comma-separated for mixed-k per-pool training "
                        "(e.g. 1,2,3, predata_fromList_123.py:45-110)")
    p.add_argument("--dp", default=None,
                   help="data-parallel mesh extent: an integer or 'auto' "
                        "(all devices / --mp); batches shard over the mesh's "
                        "data axis, gradients all-reduce over NCCL (gloo on "
                        "the CPU)")
    p.add_argument("--mp", type=int, default=None,
                   help="model-parallel mesh extent (embedding table "
                        "row-sharded when it divides num_speakers)")
    return p


def _is_main() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0


def _layout(cfg, args):
    """cfg with --dp / --mp applied (as JAX's run.train applies them):
    'auto' is the devices divided by the model extent: under torchrun its
    ranks on every node (WORLD_SIZE), else the visible cards, 1 on the
    CPU."""
    if args.dp is None and args.mp is None:
        return cfg
    mp = args.mp if args.mp is not None else max(cfg.mp_size, 1)
    if args.dp in (None, "auto"):
        if "WORLD_SIZE" in os.environ:
            n_dev = int(os.environ["WORLD_SIZE"])
        elif torch.device(args.device).type == "cuda":
            n_dev = torch.cuda.device_count()
        else:
            n_dev = 1
        dp = n_dev // mp
    else:
        dp = int(args.dp)
    return cfg.replace(dp_size=max(dp, 1), mp_size=mp)


def _spawn_ranks(cfg, args, argv):
    """Start dp x mp ranks running this CLI and return rank 0's final
    state."""
    from dl4ss_tpu_torch.parallel.launch import backend_for, run_ranks
    from dl4ss_tpu_torch.parallel.mesh import (available_devices,
                                               validate_layout)
    try:
        validate_layout(cfg, available_devices(args.device))
    except ValueError as err:
        raise SystemExit(str(err)) from None
    world = cfg.dp_size * cfg.mp_size
    backend = backend_for(args.device)
    print(f"parallel: {world} ranks (data {cfg.dp_size} x model "
          f"{cfg.mp_size}) over {backend}", flush=True)
    rank_argv = argv + ["--dp", str(cfg.dp_size), "--mp", str(cfg.mp_size)]
    # each rank runs main() again, its group up: it trains instead
    return run_ranks(main, world, (rank_argv,), backend)


def _join_launcher_group(args) -> None:
    """Join the group of the ranks an outside launcher (torchrun) started:
    its address, rank and world size are in the environment."""
    from dl4ss_tpu_torch.parallel.launch import RENDEZVOUS_S, backend_for
    backend = backend_for(args.device)
    if backend == "nccl":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group(
        backend, timeout=datetime.timedelta(seconds=RENDEZVOUS_S))
    if _is_main():
        print(f"parallel: {dist.get_world_size()} ranks from the launcher "
              f"over {backend}", flush=True)


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    p = build_parser()
    args = p.parse_args(argv)

    if args.list_dir and args.mode in _QUERY_MODES:
        raise SystemExit(f"--list-dir is not supported in {args.mode} mode")
    if args.file_lists and args.mode != "memory":
        raise SystemExit("--file-lists is the Cocktail memory-mode "
                         "protocol (run.train --mode memory); separator "
                         "training uses --list-dir / --data-root")
    if args.noise_wavs and (args.list_dir or args.mode in _QUERY_MODES):
        raise SystemExit(_NOISE_REFUSAL)
    if args.mode == "tasnet" and (args.list_dir or args.file_lists
                                  or args.noise_wavs or args.checkpoint_dir
                                  or args.resume or args.init_from
                                  or args.dp or args.mp):
        raise SystemExit("--mode tasnet trains from the bank on one device "
                         "and writes no checkpoint: drop the list, noise, "
                         "checkpoint and mesh options")
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
    cfg = _layout(cfg, args)
    if cfg.dp_size * cfg.mp_size > 1 and not dist.is_initialized():
        if "WORLD_SIZE" not in os.environ:
            return _spawn_ranks(cfg, args, argv)
        _join_launcher_group(args)
    # the trainer family fixes the query modality: rebind cfg.mode and
    # check the dataset against it (MODE 1-4, Torch_multi/config.py:66-76)
    want_mode = {"video": "video", "image-query": "image"}.get(args.mode)
    if args.mode == "memory":
        want_mode = {"image": "image", "video": "video"}.get(
            args.query_source, "speech")
    if want_mode is not None and cfg.mode != want_mode:
        cfg = cfg.replace(mode=want_mode).validate()
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
        if args.checkpoint_dir and _is_main():
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
    elif args.file_lists:
        from dl4ss_tpu_torch.data.wavlist import train_bank_from_wavlist
        bank_np, spk2idx = train_bank_from_wavlist(
            os.path.join(args.file_lists, "train_wavlist.txt"),
            args.wav_root or ".", cfg, utts_per_speaker=args.utts)
        bank = torch.as_tensor(bank_np, device=device)
        cfg = cfg.replace(num_speakers=len(spk2idx))
        if args.checkpoint_dir and _is_main():
            # the wavlist evaluator indexes memory rows through it
            write_vocab(args.checkpoint_dir, spk2idx)
    else:
        bank, cfg, idx2spk = load_bank(cfg, args, device)
        if args.mode == "memory" and args.checkpoint_dir and _is_main():
            # memory-mode evaluators need the speaker -> memory-row mapping
            # of THIS training bank
            write_vocab(args.checkpoint_dir,
                        {s: i for i, s in idx2spk.items()})
    if args.noise_wavs:
        noise_bank = load_noise_bank(args.noise_wavs, cfg, device)
        cfg = cfg.replace(add_bgd_noise=True)
    if ck_cfg is not None and cfg.num_speakers != ck_cfg.num_speakers:
        raise SystemExit(
            f"--resume: the data source has {cfg.num_speakers} speakers "
            f"but the checkpoint was trained with {ck_cfg.num_speakers}; "
            f"resume with the original data/lists")
    print(cfg.log_config())
    if args.mode == "tasnet":
        return _run_tasnet_mode(cfg, bank, args, device)
    if args.mode == "memory":
        return _run_memory_mode(cfg, bank, args, device)
    if args.mode in ("video", "image-query"):
        return _run_query_mode(cfg, bank, args, device)
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


def _query_bank(cfg, args, query_source: str, device):
    """(feats key, the query bank on `device`) of a query source: the
    lip-frame bank (S, C, T, H, W, 3) or the digit bank (S, V, 28, 28, 1)
    of the synthetic glyphs."""
    if query_source == "video":
        frames = load_frame_bank(cfg, args, frame_hw(args), args.seed)
        return "query_video", torch.as_tensor(frames, device=device)
    from dl4ss_tpu_torch.data.mnist import digit_query_bank, load_mnist
    imgs, labels = load_mnist(None)
    return "query_image", torch.as_tensor(
        digit_query_bank(imgs, labels, cfg.num_speakers), device=device)


def _run_query_mode(cfg, bank, args, device):
    """Query-conditioned separation training: GRID lip clips (video,
    Torch_multi/main_run.py:226-256) or MNIST digit queries (image-query,
    Multi_modal nnet.py:70-90), with the auxiliary speaker CE on the video
    logits (main_run.py:451)."""
    from dl4ss_tpu_torch.train.query_trainer import (query_batch,
                                                     query_train_loop)

    query_source = "video" if args.mode == "video" else "image"
    qkey, qbank = _query_bank(cfg, args, query_source, device)

    def make_batch(generator):
        return query_batch(generator, bank, cfg, qkey, qbank)

    dev = make_batch(torch.Generator().manual_seed(args.seed + 13))
    try:
        state, sdr = query_train_loop(
            cfg, make_batch, seed=args.seed, max_epochs=args.epochs,
            epoch_size=args.epoch_size, query_source=query_source,
            video_trunk=args.video_trunk, frame_hw=frame_hw(args),
            metrics_path=args.metrics, checkpoint_dir=args.checkpoint_dir,
            resume=args.resume, dev_batch=dev, eval_every=args.eval_every,
            init_from=args.init_from, device=device)
    except ValueError as err:
        if args.init_from and "do not match the model" in str(err):
            raise SystemExit(f"--init-from: {err}") from None
        raise
    if sdr:
        print(f"final SI-SDR: {sdr[-1]:.2f} dB (best {max(sdr):.2f})")
    return state


def _run_tasnet_mode(cfg, bank, args, device):
    """DPRNN-TasNet on the bank's waveforms (train/tasnet_trainer.py)."""
    from dl4ss_tpu_torch.models.dprnn import DPRNNConfig
    from dl4ss_tpu_torch.train.tasnet_trainer import tasnet_train_loop
    m = DPRNNConfig(speakers=cfg.max_mix)
    state, sdr = tasnet_train_loop(
        cfg, m, bank, seed=args.seed, max_epochs=args.epochs,
        epoch_size=args.epoch_size, metrics_path=args.metrics, device=device)
    if sdr:
        print(f"final SI-SNR: {sdr[-1]:.2f} dB (best {max(sdr):.2f})")
    return state


def _run_memory_mode(cfg, bank, args, device):
    """Cocktail / Multi_modal training: life-long-memory target extraction
    with early stopping (train/memory_trainer.py)."""
    from dl4ss_tpu_torch.train.checkpoint import (latest_step,
                                                  restore_checkpoint,
                                                  save_checkpoint)
    from dl4ss_tpu_torch.train.memory_trainer import (create_memory_state,
                                                      memory_batch,
                                                      memory_train_loop)

    qs = args.query_source
    hw = frame_hw(args)
    qkey, qbank = (_query_bank(cfg, args, qs, device) if qs != "speech"
                   else (None, None))

    def make_batch(generator):
        return memory_batch(generator, bank, cfg, qkey, qbank)

    def template():
        return create_memory_state(cfg, args.seed, qs,
                                   args.epoch_size or cfg.epoch_size, hw,
                                   args.video_trunk, device)

    init_state = None
    try:
        if args.init_from:
            # warm start (fresh optimizer and step): the parameters AND the
            # memory rows come from the donor; the memory is model state
            # (extend_layers.py:144-145)
            donor = restore_checkpoint(args.init_from, template())
            init_state = template()
            init_state.model.load_state_dict(donor.model.state_dict())
            init_state.memory = donor.memory
            print(f"warm-started memory-mode params+memory from "
                  f"{args.init_from} (fresh optimizer)")
        elif (args.resume and args.checkpoint_dir
              and latest_step(args.checkpoint_dir) is not None):
            init_state = restore_checkpoint(args.checkpoint_dir, template())
            print(f"resumed memory-mode step {init_state.step} from "
                  f"{args.checkpoint_dir}")
    except ValueError as err:
        raise SystemExit(f"--init-from / --resume: {err}") from None

    dev = make_batch(torch.Generator().manual_seed(args.seed + 13))
    state, history = memory_train_loop(
        cfg, make_batch, seed=args.seed, max_epochs=args.epochs,
        epoch_size=args.epoch_size, query_source=qs,
        patience=args.patience, dev_batch=dev, init_state=init_state,
        frame_hw=hw, video_trunk=args.video_trunk,
        metrics_path=args.metrics, device=device)
    if history:
        print(f"dev-loss: first {history[0]:.4f} best {min(history):.4f} "
              f"({len(history)} epochs)")
    if args.checkpoint_dir:
        if _is_main():
            save_checkpoint(args.checkpoint_dir, state, cfg=cfg)
            print(f"saved memory-mode checkpoint to {args.checkpoint_dir}")
        if dist.is_initialized():
            dist.barrier()
    return state


if __name__ == "__main__":
    main()
