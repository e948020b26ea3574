"""The JAX reference learning curve of `grid_video` (conv trunk, 48x48
synthetic lips) on held-out utterances, the curve that `chip_smoke.py`'s
grid_video learning gate is set from.

The protocol is the gate's: a rehearsal tree of 101 speakers x 8
utterances (`generate_corpus`, seed 3); the model trains from each seed on
each speaker's first 6 utterances as `run.train --mode video --utts 6`
does (the same batch function, the same per-step key split as
`query_train_loop`), and is scored every 100 steps on mixtures of the last
2 utterances, which training never sees: the mean PIT SI-SDR over 16
batches of the preset's batch size, the same batches at every readout,
drawn from the seed so that the spread over seeds holds the held-out
draw's too. The Pallas flags are off, so the recurrences, the STFT and the
mask head run their plain XLA versions, which compute the same functions.
Depth may be cut with `--set encoder_layers=1` (widths stay the preset's).

    JAX_PLATFORMS=cpu python -m tools.grid_video_jax_curve \
        --seeds 0,1,2,3,4,5,6,7 --set encoder_layers=1

Prints one JSON object a seed: the configuration, the readouts and their
times.
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np

from dl4ss_tpu.config import preset
from dl4ss_tpu.data.dirtree import DirTreeSampler
from dl4ss_tpu.data.rehearsal import generate_corpus
from dl4ss_tpu.data.synth import featurize, sample_mixtures
from dl4ss_tpu.data.video import synthetic_frame_bank
from dl4ss_tpu.run.common import apply_overrides
from dl4ss_tpu.train.query_trainer import (create_query_state,
                                           make_query_eval_step,
                                           make_query_train_step)

SPEAKERS, UTTS, TRAIN_UTTS, TREE_SEED = 101, 8, 6, 3
STEPS, EVERY, HELD_BATCHES = 500, 100, 16


def curve(cfg, args, seed: int, train_bank, held_bank) -> dict:
    """Train from `seed` for STEPS steps, reading the held-out SI-SDR
    every EVERY."""
    frames = jnp.asarray(synthetic_frame_bank(cfg.num_speakers, 2, 4,
                                              (48, 48), seed=seed))

    def make_batch(key, bank):
        k_mix, k_clip = jax.random.split(key)
        b = sample_mixtures(k_mix, bank, cfg)
        feats = featurize(b, cfg)
        ci = jax.random.randint(k_clip, b.spk_idx.shape, 0, frames.shape[1])
        feats["query_video"] = frames[b.spk_idx, ci]
        return feats

    held_batches = [make_batch(jax.random.PRNGKey(
        10 ** 6 + 1000 * seed + i), held_bank)
        for i in range(HELD_BATCHES)]
    state = create_query_state(jax.random.PRNGKey(seed), cfg, "video",
                               STEPS)
    step = make_query_train_step(cfg, "video", STEPS)
    score = make_query_eval_step(cfg, "video")
    batch = jax.jit(make_batch)

    def held_out():
        return float(np.mean([np.mean(np.asarray(
            score(state.params, f)["si_sdr"])) for f in held_batches]))

    readouts, t0 = [(0, held_out())], time.perf_counter()
    for i in range(1, STEPS + 1):
        rng, sub = jax.random.split(state.rng)
        state, metrics = step(state._replace(rng=rng), batch(sub, train_bank))
        if i % EVERY == 0:
            readouts.append((i, held_out()))
            print(f"seed {seed} step {i}: held-out SI-SDR "
                  f"{readouts[-1][1]:.3f} dB, query CE "
                  f"{float(metrics['query_ce']):.3f} "
                  f"({time.perf_counter() - t0:.0f} s)", flush=True)
    return {"package": "dl4ss_tpu (JAX)", "backend": jax.default_backend(),
            "preset": "grid_video", "overrides": args.set, "seed": seed,
            "speakers": cfg.num_speakers, "train_utts": TRAIN_UTTS,
            "held_utts": UTTS - TRAIN_UTTS,
            "held_batches": HELD_BATCHES,
            "batch_size": cfg.batch_size, "curve": readouts,
            "gain": readouts[-1][1] - readouts[0][1],
            "query_ce": float(metrics["query_ce"]),
            "seconds": time.perf_counter() - t0}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seeds", default="0",
                   help="comma-separated seeds, one curve each")
    p.add_argument("--set", action="append", default=[],
                   metavar="KEY=VALUE")
    p.set_defaults(batch_size=None)           # read by apply_overrides
    args = p.parse_args(argv)
    args.set = ["use_pallas_rnn=false", "use_pallas_stft=false",
                "use_pallas_maskhead=false", *args.set]
    cfg = apply_overrides(preset("grid_video"), args)
    with tempfile.TemporaryDirectory() as tmp:
        generate_corpus(tmp, n_spk=SPEAKERS, utts=UTTS,
                        seconds=cfg.max_len / cfg.frame_rate, tr_entries=16,
                        cv_entries=4, tt_entries=4, seed=TREE_SEED,
                        cv_holdout=1)
        root = os.path.join(tmp, "wsj0")
        train = DirTreeSampler(root, cfg, "si_tr_s", TRAIN_UTTS)
        held = DirTreeSampler(root, cfg, "si_tr_s", UTTS - TRAIN_UTTS,
                              utts_offset=TRAIN_UTTS)
    cfg = cfg.replace(num_speakers=train.num_speakers, max_epoch=1)
    train_bank, held_bank = (jnp.asarray(train.bank), jnp.asarray(held.bank))
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(curve(cfg, args, seed, train_bank, held_bank)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
