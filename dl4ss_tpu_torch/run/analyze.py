"""Embedding analyzer — PCA of the trained speaker-embedding table (the port
of `dl4ss_tpu/run/analyze.py`).

Rebuilds Torch_multi/analyze_data.py:8-19 (PCA(2) of the SPEECH_EMBEDDING
weights): writes a CSV of 2-D coordinates per speaker and, when matplotlib
imports, a scatter PNG.

    python -m dl4ss_tpu_torch.run.analyze --checkpoint-dir ck --out emb_pca
"""

from __future__ import annotations

import argparse

import numpy as np

from dl4ss_tpu_torch.device import resolve_device
from dl4ss_tpu_torch.run.common import (add_common_args, build_cfg,
                                        checkpoint_cfg, restore_for_eval)


def pca2(x: np.ndarray) -> np.ndarray:
    x = x - x.mean(axis=0, keepdims=True)
    _, _, vt = np.linalg.svd(x, full_matrices=False)
    return x @ vt[:2].T


def main(argv=None):
    p = add_common_args(argparse.ArgumentParser(description=__doc__))
    p.add_argument("--out", default="emb_pca")
    args = p.parse_args(argv)
    # the state's shapes come from the training config (list-mode
    # checkpoints carry their own speaker count)
    cfg = checkpoint_cfg(build_cfg(args), args)
    state = restore_for_eval(cfg, args, resolve_device(args.device))
    table = state.model.embedding.table.detach().float().cpu().numpy()
    coords = pca2(table)
    csv = args.out + ".csv"
    with open(csv, "w") as f:
        f.write("speaker,pc1,pc2\n")
        for i, (a, b) in enumerate(coords):
            f.write(f"{i},{a:.6f},{b:.6f}\n")
    print("wrote", csv)
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        plt.figure(figsize=(6, 6))
        plt.scatter(coords[:, 0], coords[:, 1], s=12)
        plt.title("speaker embeddings (PCA-2)")
        plt.savefig(args.out + ".png", dpi=120)
        print("wrote", args.out + ".png")
    except ImportError as e:
        print("no plot:", e)
    return coords


if __name__ == "__main__":
    main()
