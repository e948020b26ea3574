"""Evaluation CLI — the port of `dl4ss_tpu/run/evaluate.py`: held-out
mixtures scored by SI-SDR on the device and, on request, by BSS-Eval
SDR / SIR / SAR (the reference's bss_test.cal protocol), with the oracle
bound and the wavs exported under the batch_output naming contract.

    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck --batches 10
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --teacher-forced
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --mode recursive [--candidates 6]
    python -m dl4ss_tpu_torch.run.evaluate --checkpoint-dir ck \
        --list-dir corpus/lists --wav-root corpus --split test \
        --teacher-forced --bss-eval --oracle irm --export-wavs out
    python -m dl4ss_tpu_torch.run.score out --nsdr

`--mode separate` scores the top-k separator with teacher-forced speakers
(`--teacher-forced`) or the classifier's top-k, optionally with the
1-speaker complement mask, a per-sample candidate roster (`--candidates
N`, with the speaker hit rate) or embedding-cosine dedup (`--dedup`);
`--mode recursive` scores the peel loop per step, with the speaker hit
rate. The data: the synthetic bank or a speaker tree (`--data-root`,
`--batches` batches, default 4), or the whole of a split of the official
wsj0-mix lists (`--list-dir`, `--mix-k` pools, speakers indexed by the
training run's vocab.json; `--batches` caps it); `--noise-wavs` adds street
noise to every mixture. The model is `--checkpoint-dir`'s latest step under
its cfg.json, with `--graft component=dir,...` over it (random weights from
--seed without either).

    python -m dl4ss_tpu_torch.run.evaluate --mode memory --checkpoint-dir ck
    python -m dl4ss_tpu_torch.run.evaluate --mode memory --checkpoint-dir ck \
        --unk-holdout 2 | --unk-root other_tree [--enroll-seconds 1]
    python -m dl4ss_tpu_torch.run.evaluate --mode memory --checkpoint-dir ck \
        --file-lists lists --wav-root . --split dev|test|unk

`--mode memory` scores the Cocktail extractor: the trained memory rows
drive the masks of known speakers; unknown speakers (the last
--unk-holdout bank speakers, or a disjoint tree under --unk-root) are
enrolled from --enroll-seconds of their audio first, the first into the
reserved unk row and the rest into appended rows. `--file-lists` re-mixes
the Cocktail wavlists deterministically, `--split unk` enrolling from the
supplemental column. It prints SI-SDR, its improvement over the mixture
and the BSS-Eval 2.0 gain (SDR / SIR / SAR / NSDR).
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dl4ss_tpu_torch.data.synth import (add_noise_to_mix, featurize,
                                        sample_mixtures)
from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.eval.bss_eval import bss_eval_sources
from dl4ss_tpu_torch.eval.oracle import oracle_mask_sisdr
from dl4ss_tpu_torch.eval.wav_export import export_batch_outputs
from dl4ss_tpu_torch.models.separator import classify_speakers
from dl4ss_tpu_torch.objectives.select import (candidate_pools,
                                               candidate_restricted_select,
                                               cosine_dedup_select)
from dl4ss_tpu_torch.run.common import (add_common_args, build_cfg,
                                        checkpoint_cfg, load_bank,
                                        load_noise_bank, read_vocab,
                                        restore_for_eval)
from dl4ss_tpu_torch.train.checkpoint import load_cfg
from dl4ss_tpu_torch.train.steps import (make_eval_step,
                                         make_recursive_eval_step)

def _hits(spk_idx: torch.Tensor, live: torch.Tensor, chosen: torch.Tensor):
    """(true speakers recovered in `chosen`, true speakers) over a batch."""
    hits = total = 0
    for true, alive, pick in zip(spk_idx.tolist(), live.tolist(),
                                 chosen.tolist()):
        tset = {s for s, a in zip(true, alive) if a}
        hits += len(tset & set(pick))
        total += len(tset)
    return hits, total


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--batches", type=int, default=None,
                   help="bank modes: batches to score (default 4); list "
                        "mode: a cap on the whole split's batch count")
    p.add_argument("--mode", default="separate",
                   choices=["separate", "recursive", "memory"],
                   help="memory = Cocktail/Multi_modal target "
                        "extraction driven by the life-long speaker memory, "
                        "with optional unknown-speaker enrollment; "
                        "recursive = peel-and-subtract extraction scored "
                        "per step (main_run_multi_selfSS_recu.py:341-409)")
    p.add_argument("--query-source", default="speech",
                   choices=["speech", "image", "video"],
                   help="memory mode: which modality trained the memory "
                        "(video = lip-frame queries in the VIDEO slot)")
    p.add_argument("--frame-size", type=int, default=48,
                   help="memory mode, video query: square frame edge the "
                        "checkpoint was trained with")
    p.add_argument("--video-trunk", default="conv",
                   choices=["conv", "inception"],
                   help="memory mode, video query: the checkpoint's "
                        "per-frame trunk")
    p.add_argument("--enroll-seconds", type=float, default=1.0,
                   help="memory mode: seconds of unknown-speaker audio "
                        "enrolled before scoring (predict.py:160-180)")
    p.add_argument("--unk-holdout", type=int, default=0,
                   help="memory mode: treat the LAST N bank speakers as "
                        "unknown: enroll each from a spare utterance, then "
                        "score memory-only extraction")
    p.add_argument("--unk-root", default=None,
                   help="memory mode: speaker tree of UNKNOWN speakers "
                        "(disjoint from training); overrides --unk-holdout")
    p.add_argument("--file-lists", default=None, metavar="DIR",
                   help="memory mode: directory of Cocktail wavlists "
                        "(generate_file_lists output), re-mixed "
                        "deterministically (predict.py:104-155); --split "
                        "dev/test picks the list, --split unk runs the "
                        "enrollment protocol (predict.py:160-180)")
    p.add_argument("--teacher-forced", action="store_true",
                   help="use the ground-truth speakers; default: the "
                        "classifier's top-k")
    p.add_argument("--complement-mask", action="store_true",
                   help="1-speaker complement trick: channel 2's mask "
                        "becomes 1 - mask_1 when the classifier sees one "
                        "speaker (TestVer:473-476)")
    p.add_argument("--candidates", type=int, default=None, metavar="N",
                   help="restrict classifier selection to a per-sample "
                        "roster of N speakers (the true ones + random "
                        "distractors, predata_multiSpeechTest.py:89-115)")
    p.add_argument("--dedup", action="store_true",
                   help="speaker selection by embedding-cosine dedup "
                        "(main_run_multi_selfSS_quchong.py:398-445)")
    p.add_argument("--list-dir", default=None,
                   help="official wsj0-2mix list directory "
                        "(create-speaker-mixtures): score the whole cv / tt "
                        "split (--split) instead of sampled mixtures")
    p.add_argument("--wav-root", default=None,
                   help="root the list wav paths are relative to")
    p.add_argument("--mix-k", default="2",
                   help="list mode: mixture speaker count(s), "
                        "comma-separated for mixed-k pools (e.g. 1,2,3, "
                        "predata_fromList_123.py)")
    p.add_argument("--bss-eval", action="store_true",
                   help="also run BSS-Eval (SDR / SIR / SAR, 512 taps)")
    p.add_argument("--oracle", default=None, choices=["iam", "irm"],
                   help="also report the oracle-mask SI-SDR bound of the "
                        "eval data (ideal amplitude / ratio mask)")
    p.add_argument("--export-wavs", default=None,
                   help="directory for batch_output-style wavs, scoreable "
                        "with run.score (the bss_test.cal rebuild)")
    p.add_argument("--noise-wavs", default=None,
                   help="directory of background-noise wavs added to every "
                        "eval mixture (predict.py:152-158; the noisedB "
                        "condition); the sources stay the clean references")
    p.add_argument("--graft", default=None,
                   help="checkpoint-zoo composition: comma-separated "
                        "component=ckpt_dir pairs grafted over "
                        "--checkpoint-dir (e.g. classifier=ck_cls)")
    args = p.parse_args(argv)

    if args.mode == "memory":
        return _memory_eval(args)
    if args.mode == "recursive" and (args.dedup or args.teacher_forced
                                     or args.complement_mask):
        raise SystemExit(
            "--mode recursive selects one speaker per peel step itself; "
            "--dedup/--teacher-forced/--complement-mask apply to the "
            "simultaneous top-k evaluator only (--candidates composes: it "
            "restricts each peel step to the roster)")
    if args.candidates and (args.dedup or args.teacher_forced):
        raise SystemExit("--candidates is its own selection protocol; drop "
                         "--dedup/--teacher-forced")

    # the training config governs the state, the protocol and the audio
    # geometry, so it is adopted before the eval data is built
    cfg = checkpoint_cfg(build_cfg(args), args)
    ck_cfg = load_cfg(args.checkpoint_dir) if args.checkpoint_dir else None
    if args.candidates and args.candidates < cfg.top_k:
        raise SystemExit(f"--candidates must be >= top_k={cfg.top_k}")
    device = resolve_device(args.device)
    list_batches = None
    if args.list_dir:
        # the reference's protocol: mean SDR over the official cv / tt lists
        # (TDAA_beta/main_run_sstune_TestVer.py:30-31,513), speakers indexed
        # by the TRAINING vocabulary that run.train records
        from dl4ss_tpu_torch.data.listsampler import Wsj0MixSampler
        mix_ks = tuple(int(x) for x in str(args.mix_k).split(","))
        sampler = Wsj0MixSampler(args.list_dir, args.wav_root or ".", cfg,
                                 args.split, mix_ks=mix_ks,
                                 spk2idx=read_vocab(args.checkpoint_dir),
                                 device=device)
        data_speakers = sampler.num_speakers
        cfg = cfg.replace(num_speakers=max(cfg.num_speakers, data_speakers))
        idx2spk = sampler.idx2spk
        list_batches = sampler.batches(cfg.batch_size_eval, shuffle=False)
        n_batches = sampler.num_batches(cfg.batch_size_eval)
        if n_batches == 0:
            raise SystemExit(
                f"every mixture-list pool has fewer than batch_size_eval="
                f"{cfg.batch_size_eval} entries: no full batch can be "
                f"formed; lower batch_size_eval or extend the lists")
        if args.batches is not None:
            n_batches = min(n_batches, args.batches)
    else:
        if args.mode == "separate" and cfg.max_mix != cfg.top_k:
            raise SystemExit(
                f"the sampler draws max_mix={cfg.max_mix} channels and the "
                f"top-k evaluator scores top_k={cfg.top_k} of them: set "
                f"max_mix to top_k (fewer live speakers per mixture through "
                f"min_mix); --mode recursive takes any count")
        bank, cfg, idx2spk = load_bank(cfg, args, device)
        data_speakers = cfg.num_speakers
        n_batches = args.batches if args.batches is not None else 4
    if ck_cfg is not None:
        # speaker ids past the trained embedding rows would be gathered out
        # of range
        if data_speakers > ck_cfg.num_speakers:
            raise SystemExit(
                f"the eval data references {data_speakers} speakers but the "
                f"checkpoint was trained with {ck_cfg.num_speakers}; use the "
                f"training data / vocabulary or a matching checkpoint")
        cfg = cfg.replace(num_speakers=ck_cfg.num_speakers)
    state = restore_for_eval(cfg, args, device)
    model = state.model
    ev = (make_recursive_eval_step(cfg) if args.mode == "recursive"
          else make_eval_step(cfg))
    noise_bank = (load_noise_bank(args.noise_wavs, cfg, device)
                  if args.noise_wavs else None)

    all_sisdr, all_sdr, all_oracle = [], [], []
    hits = hit_total = 0
    generator = torch.Generator().manual_seed(args.seed + 1)
    for b in range(n_batches):
        if list_batches is not None:
            batch = next(list_batches)
        else:
            batch = sample_mixtures(generator, bank, cfg, train=False)
        if noise_bank is not None:
            batch = add_noise_to_mix(generator, batch, noise_bank, cfg)
        feats = featurize(batch, cfg)
        live = batch.gains > 0
        if args.oracle:
            all_oracle.append(oracle_mask_sisdr(
                batch.mix_wav, batch.source_wavs, cfg, kind=args.oracle,
                live=live).cpu().numpy())
        pools = None
        if args.candidates:
            pools = candidate_pools(generator, feats["spk_idx"],
                                    feats["channel_live"], args.candidates,
                                    cfg.num_speakers)
        if args.mode == "recursive":
            if pools is not None:
                feats["candidates"] = pools
            out = ev(model, feats)
            chosen = out["spk_steps"]
        elif args.dedup or pools is not None:
            with torch.no_grad():
                probs = classify_speakers(model, feats["mix_feas"], cfg)
            if args.dedup:
                sel = cosine_dedup_select(probs, model.embedding.table,
                                          cfg.quchong_alpha, cfg.top_k)
            else:
                sel = candidate_restricted_select(probs, pools, cfg.top_k)
            chosen = sel
            out = ev(model, dict(feats, spk_idx=sel), teacher_forced=True,
                     complement_mask=args.complement_mask)
        else:
            chosen = None
            out = ev(model, feats, teacher_forced=args.teacher_forced,
                     complement_mask=args.complement_mask)
        if chosen is not None and (args.mode == "recursive"
                                   or pools is not None):
            h, n = _hits(batch.spk_idx, live, chosen)
            hits, hit_total = hits + h, hit_total + n
        all_sisdr.append(out["si_sdr"].float().cpu().numpy())
        if args.bss_eval:
            k_ref = feats["source_wavs"].shape[1]
            if out["pred_wavs"].shape[1] != k_ref:
                raise SystemExit(
                    f"--bss-eval needs square channel counts; recursive "
                    f"ran {out['pred_wavs'].shape[1]} peel steps against "
                    f"{k_ref} reference channels: set recursive_max_steps="
                    f"{k_ref} (or score an exported directory with "
                    f"run.score --pad-silent)")
            res = bss_eval_sources(feats["source_wavs"].float(),
                                   out["pred_wavs"].float(), flen=512)
            # dead (zero-gain) channels score ~-120 dB against a silent
            # reference: keep the live ones, gathered through the chosen
            # permutation (sdr[j] scores estimate j against source perm[j])
            live_perm = torch.gather(live, 1, res.perm)
            all_sdr.append(res.sdr[live_perm].cpu().numpy())
        if args.export_wavs:
            # every batch lands in one directory (the index offset by the
            # batch), so run.score over it reproduces the per-epoch
            # bss_test.cal protocol (main_run_multi_selfSS_recu.py:408-409)
            names = [[idx2spk[s] for s in row]
                     for row in batch.spk_idx.tolist()]
            # recursive pre-wavs are peel steps: each is named by the
            # speaker the loop extracted
            pred_names = ([[idx2spk[s] for s in row]
                           for row in out["spk_steps"].tolist()]
                          if args.mode == "recursive" else None)
            n = export_batch_outputs(
                args.export_wavs, batch.mix_wav.cpu().numpy(),
                out["pred_wavs"].float().cpu().numpy(), None, names,
                cfg.frame_rate, clean=(b == 0),
                real_wavs=batch.source_wavs.cpu().numpy(),
                idx_offset=b * batch.mix_wav.shape[0],
                live=live.cpu().numpy(), pred_names=pred_names)
            if b == n_batches - 1:
                print(f"exported wavs for {n_batches} batches to "
                      f"{args.export_wavs}/ (score with python -m "
                      f"dl4ss_tpu_torch.run.score {args.export_wavs})")

    sisdr = float(np.mean(np.concatenate(all_sisdr)))
    print(f"SI-SDR over {n_batches} batches: {sisdr:.2f} dB")
    if all_oracle:
        ob = float(np.mean(np.concatenate(all_oracle)))
        print(f"oracle {args.oracle.upper()} bound: {ob:.2f} dB "
              f"(gap {ob - sisdr:.2f} dB)")
    if hit_total:
        print(f"speaker hit rate: {hits}/{hit_total} "
              f"({100.0 * hits / hit_total:.1f}%)")
    if all_sdr:
        print(f"BSS-Eval SDR: {float(np.mean(np.concatenate(all_sdr))):.4f} "
              f"dB over {sum(len(x) for x in all_sdr)} channels")
    return sisdr


def _memory_eval(args):
    """Memory-driven target extraction scoring (the Cocktail evaluator):

      * known speakers: the trained memory row alone drives the mask
        (predict.py:231-245);
      * unknown speakers (--unk-holdout / --unk-root): enroll
        --enroll-seconds of their audio into a fresh row first
        (predict.py:160-180), the first into the reserved unk row, each
        further one into an appended row of its own (lifting the
        reference's batch-size-1 restriction, predict.py:48-50).

    Reports SI-SDR of the extracted target, its improvement over the raw
    mixture, and the BSS-Eval 2.0 gain decomposition with NSDR (the
    reference's headline Cocktail metric, BSS_EVAL.m:8-21)."""
    from dl4ss_tpu_torch.data.listsampler import mix_from_list
    from dl4ss_tpu_torch.data.synth import (linear_target_mags,
                                            normalize_utterance)
    from dl4ss_tpu_torch.eval.bss_eval import gain_nsdr
    from dl4ss_tpu_torch.eval.sisdr import si_sdr
    from dl4ss_tpu_torch.models.memory import (memory_extend,
                                               memory_reset_rows)
    from dl4ss_tpu_torch.ops.stft import istft_cfg, spectral_feature_cfg
    from dl4ss_tpu_torch.run.common import apply_graft, frame_hw
    from dl4ss_tpu_torch.train.checkpoint import restore_checkpoint
    from dl4ss_tpu_torch.train.memory_trainer import (create_memory_state,
                                                      enroll,
                                                      make_memory_eval_step,
                                                      unk_row)
    from dl4ss_tpu_torch.train.steps import _mixture_phasor

    # state shapes come from the training config; the CLI's runtime
    # overrides (batch_size_eval etc.) still win on top
    cfg = checkpoint_cfg(build_cfg(args), args)
    device = resolve_device(args.device)
    state = create_memory_state(cfg, args.seed, args.query_source,
                                frame_hw=frame_hw(args),
                                video_trunk=args.video_trunk, device=device)
    if args.checkpoint_dir:
        state = restore_checkpoint(args.checkpoint_dir, state)
        print(f"restored step {state.step} from {args.checkpoint_dir}")
    if args.graft:
        state = apply_graft(state, args.graft, cfg)
    ev = make_memory_eval_step(cfg, args.query_source)

    def score(memory, batch, spk_id):
        feats = featurize(batch, cfg)
        mix_mag, target_mag = linear_target_mags(feats, batch, cfg)
        out = ev(state.model, memory,
                 {"mix_feas": feats["mix_feas"], "mix_mag": mix_mag,
                  "spk_id": spk_id, "target_mag": target_mag,
                  # a checkpoint fine-tuned under loss_mode='si_sdr' reports
                  # -SI-SDR and needs the resynthesis inputs
                  "mix_ri": feats["mix_ri"],
                  "target_wav": batch.source_wavs[:, 0]})
        with torch.no_grad():
            wav = istft_cfg(out["pred_mag"] * _mixture_phasor(
                feats["mix_ri"]), cfg, length=cfg.max_len)
            target = batch.source_wavs[:, 0]
            pred_sdr = si_sdr(wav, target)
            mix_sdr = si_sdr(batch.mix_wav, target)
            res, g_ns = gain_nsdr(wav, batch.mix_wav, batch.source_wavs,
                                  live=batch.gains > 0)
        gain = {k: v.float().cpu().numpy() for k, v in
                (("sdr", res.sdr), ("sir", res.sir), ("sar", res.sar),
                 ("nsdr", g_ns))}
        return (pred_sdr.cpu().numpy(), (pred_sdr - mix_sdr).cpu().numpy(),
                gain)

    def report(label, sdrs, gains, g_rows):
        sisdr = float(np.mean(np.concatenate(sdrs)))
        ns = float(np.mean(np.concatenate(gains)))
        gm = {k: float(np.mean(np.concatenate([r[k] for r in g_rows])))
              for k in g_rows[0]}
        print(f"{label}: SI-SDR {sisdr:.2f} dB (SI-SDR NSDR {ns:+.2f} dB)")
        print(f"BSS-Eval 2.0 gain (BSS_EVAL.m): SDR {gm['sdr']:.2f} "
              f"SIR {gm['sir']:.2f} SAR {gm['sar']:.2f} "
              f"NSDR {gm['nsdr']:+.2f} dB")
        return {"si_sdr": sisdr, "nsdr": ns, "gain": gm}

    if args.file_lists:
        return _wavlist_protocol(args, cfg, state, score, report, device)

    bank, bank_cfg, _ = load_bank(cfg, args, device)
    if bank_cfg.num_speakers != cfg.num_speakers:
        raise SystemExit(
            f"data root has {bank_cfg.num_speakers} speakers but the "
            f"checkpoint was trained with {cfg.num_speakers}")

    unk_bank = None
    if args.unk_root:
        from dl4ss_tpu_torch.data.dirtree import DirTreeSampler
        unk = DirTreeSampler(args.unk_root, cfg, args.split, 2)
        unk_bank = torch.as_tensor(unk.bank, device=device)
        trained_bank = bank
    elif args.unk_holdout:
        unk_bank = bank[-args.unk_holdout:]
        trained_bank = bank[:-args.unk_holdout]

    generator = torch.Generator().manual_seed(args.seed + 1)
    sdrs, gains, g_rows = [], [], []
    if unk_bank is None:
        # known speakers: the memory rows from training drive the mask
        n_b = args.batches if args.batches is not None else 4
        for _ in range(n_b):
            batch = sample_mixtures(generator, bank, cfg, train=False)
            s, g, gr = score(state.memory, batch, batch.spk_idx[:, 0])
            sdrs.append(s)
            gains.append(g)
            g_rows.append(gr)
        return report(f"memory-eval over {n_b} batches", sdrs, gains,
                      g_rows)

    if args.query_source != "speech":
        raise SystemExit("unknown-speaker enrollment is the voiceprint "
                         "(speech) protocol")
    if not cfg.unk_spk:
        raise SystemExit(
            "unknown-speaker evaluation needs a model trained with "
            "unk_spk=true — the config that reserves the unk memory row "
            "(SpkLifeLongMemory's unk slot, extend_layers.py:133-136)")
    n_unk, n_utt = unk_bank.shape[:2]
    n_trained = trained_bank.shape[0]
    supp = min(int(args.enroll_seconds * cfg.frame_rate), cfg.max_len)
    base_rows = state.memory.vectors.shape[0]
    rows = [unk_row(cfg)] + list(range(base_rows, base_rows + n_unk - 1))
    memory = memory_extend(state.memory, n_unk - 1)
    for u in range(n_unk):
        row = torch.tensor([rows[u]], device=device)
        memory = memory_reset_rows(memory, row)
        ewav = normalize_utterance(unk_bank[u, min(1, n_utt - 1)])[:supp]
        ewav = torch.nn.functional.pad(ewav, (0, cfg.max_len - supp))
        efeat, _ = spectral_feature_cfg(ewav[None], cfg)
        memory = enroll(state.model, memory, cfg, row, efeat,
                        args.query_source)
    b = cfg.batch_size_eval
    for u in range(n_unk):
        # b mixtures: the unk target utterance + one random trained
        # interferer each
        spk = torch.randint(0, n_trained, (b,), generator=generator)
        utt = torch.randint(0, trained_bank.shape[1], (b,),
                            generator=generator)
        spk, utt = spk.to(device), utt.to(device)
        flat = torch.cat([unk_bank[u, :1], trained_bank[spk, utt]], dim=0)
        utt_idx = torch.stack([torch.zeros(b, dtype=torch.long,
                                           device=device),
                               1 + torch.arange(b, device=device)], dim=1)
        spk_idx = torch.stack([torch.full((b,), rows[u], device=device),
                               spk], dim=1)
        batch = mix_from_list(flat, utt_idx,
                              torch.zeros((b, 2), device=device), spk_idx,
                              cfg)
        s, g, gr = score(memory, batch, spk_idx[:, 0])
        sdrs.append(s)
        gains.append(g)
        g_rows.append(gr)
    out = report(f"unk-speaker eval ({n_unk} speakers, "
                 f"{args.enroll_seconds:.2f}s enrollment)", sdrs, gains,
                 g_rows)
    return dict(out, n_unk=n_unk)


def _wavlist_protocol(args, cfg, state, score, report, device):
    """Deterministic Cocktail list-driven evaluation: every mixture is
    re-mixed from the wavlist columns as the reference evaluator does
    (predict.py:104-155). --split dev/test scores known speakers (memory
    rows drive the mask); --split unk enrolls each unknown speaker from
    the supplemental-sounds column first (predict.py:160-180)."""
    import os

    from dl4ss_tpu_torch.data.wavlist import (WavListMixer, _speaker_of,
                                              enrollment_wav, parse_wavlist)

    # speaker -> memory row: the TRAINING bank's ordering, recorded beside
    # the checkpoints by run.train --mode memory; the train wavlist
    # reproduces it otherwise (both are sorted names)
    vocab = read_vocab(args.checkpoint_dir)
    if vocab is None:
        tl = os.path.join(args.file_lists, "train_wavlist.txt")
        if os.path.exists(tl):
            names = sorted({r.speaker for r in parse_wavlist(tl)})
            vocab = {s: i for i, s in enumerate(names)}
    if vocab is None:
        raise SystemExit(
            "--file-lists: no speaker vocabulary — the checkpoint dir has "
            "no vocab.json and the list dir no train_wavlist.txt")
    names = {"dev": "dev_wavlist.txt", "valid": "dev_wavlist.txt",
             "test": "test_wavlist.txt", "unk": "unk_wavlist.txt"}
    if args.split not in names:
        raise SystemExit(f"--file-lists evaluates --split dev/test/unk, "
                         f"got {args.split!r}")
    rows = parse_wavlist(os.path.join(args.file_lists, names[args.split]))
    root = args.wav_root or "."
    b = cfg.batch_size_eval

    target_rows = None
    memory = state.memory
    if args.split == "unk":
        if args.query_source != "speech":
            raise SystemExit("unk enrollment is the voiceprint (speech) "
                             "protocol")
        if not cfg.unk_spk:
            raise SystemExit("unk evaluation needs a model trained with "
                             "unk_spk=true (the reserved unk memory row)")
        from dl4ss_tpu_torch.models.memory import (memory_extend,
                                                   memory_reset_rows)
        from dl4ss_tpu_torch.ops.stft import spectral_feature_cfg
        from dl4ss_tpu_torch.train.memory_trainer import enroll, unk_row
        # one fresh row per distinct unk speaker; the first takes the
        # reserved row, the rest append
        spk_names, first_row = [], {}
        for r in rows:
            s = _speaker_of(r.target)
            if s not in first_row:
                spk_names.append(s)
                first_row[s] = r
        base = memory.vectors.shape[0]
        mem_rows = [unk_row(cfg)] + list(range(base,
                                               base + len(spk_names) - 1))
        memory = memory_extend(memory, len(spk_names) - 1)
        for s, mrow in zip(spk_names, mem_rows):
            ridx = torch.tensor([mrow], device=device)
            memory = memory_reset_rows(memory, ridx)
            ewav = enrollment_wav(first_row[s], root, cfg,
                                  args.enroll_seconds)
            efeat, _ = spectral_feature_cfg(
                torch.as_tensor(ewav, device=device)[None], cfg)
            memory = enroll(state.model, memory, cfg, ridx, efeat,
                            args.query_source)
        by_name = dict(zip(spk_names, mem_rows))
        target_rows = {r.target: by_name[_speaker_of(r.target)]
                       for r in rows}
        print(f"enrolled {len(spk_names)} unknown speakers "
              f"({args.enroll_seconds:.2f}s each) from the supplemental "
              f"column")
    else:
        missing = sorted({r.speaker for r in rows} - set(vocab))
        if missing:
            raise SystemExit(f"list speakers {missing} absent from the "
                             f"training vocabulary")

    mixer = WavListMixer(rows, root, cfg, spk2idx=vocab, device=device)
    n_batches = (len(rows) + b - 1) // b
    print(f"wavlist bank ready: {len(mixer.utt2row)} unique utterances, "
          f"{n_batches} batches of {b}", flush=True)
    sdrs, nsdrs, g_rows = [], [], []
    for batch, n_valid in mixer.batches(b, target_rows=target_rows):
        s, ns, gr = score(memory, batch, batch.spk_idx[:, 0])
        sdrs.append(s[:n_valid])
        nsdrs.append(ns[:n_valid])
        g_rows.append({k: v[:n_valid] for k, v in gr.items()})
    n = sum(x.shape[0] for x in sdrs)
    out = report(f"wavlist {names[args.split]}: {n} list mixtures "
                 f"(deterministic)", sdrs, nsdrs, g_rows)
    return dict(out, n=n)


if __name__ == "__main__":
    main()
