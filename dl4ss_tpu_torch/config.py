"""Typed configuration with named presets.

Replaces the reference's module-global config system (`Torch_multi/config.py`,
`TDAA_beta/config.py`, `TDAA_beta/config_WSJ0_dB.py`,
`Cocktail/software/DL4SS_Keras/config_noMat.py`,
`Multi_modal/software/DL4SS_Keras/config.py`) — there, behavior variants are
selected by importing a different config module and the values are parsed from
an INI file with `eval()` (Torch_multi/config.py:178-261).  Here every knob is
a typed dataclass field, variants are named presets, and a config is an
immutable value passed explicitly (hashable, so it can be a jit static arg).

The PyTorch port's own copy of `dl4ss_tpu/config.py`: same fields, same
presets, so configs and `cfg.json` sidecars stay interchangeable between the
two packages (tests/test_torch_config.py holds them equal). In the port the
`use_pallas_stft` / `use_pallas_rnn` / `use_pallas_maskhead` flags read as
"use the hand-written CUDA kernel" (dl4ss_tpu_torch/csrc/).
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Optional, Tuple


def _field(**kw):
    return dataclasses.field(**kw)


@dataclasses.dataclass(frozen=True)
class Config:
    # ---- identity -------------------------------------------------------
    name: str = "default"
    # MODE in the reference selects the query modality
    # (Torch_multi/config.py:66-76): 1=speech, 2=image, 3=video, 4=top-down.
    mode: str = "speech"  # speech | image | video | topdown
    dataset: str = "WSJ0"  # WSJ0 | TIMIT | THCHS-30 | GRID | MNIST | synth

    # ---- audio / DSP (Torch_multi/config.py:114-130) --------------------
    frame_rate: int = 8000
    frame_length: int = 256          # int(0.032 * 8000)
    frame_shift: int = 128           # int(0.016 * 8000)
    window: str = "hann"             # hann | sine | sqrt_hann; the reference's
    # feature STFT uses librosa's default hann (predata_multiAims.py:200);
    # config.WINDOWS defines a sine window used by the log-spectral path
    # (config.py:240, predata_multiAims.py:195-197).
    log_spectral: bool = False       # IS_LOG_SPECTRAL
    max_len_seconds: float = 5.0     # MAX_LEN (seconds); 5 s @ 8 kHz = 40000
    center: bool = True              # librosa center=True reflect padding

    # ---- mixing (config.py:122-127) -------------------------------------
    min_mix: int = 2
    max_mix: int = 2
    db_range: float = 5.0            # dB — SNR-augment gain range
    augment_data: bool = False       # random circular-shift augment
    add_bgd_noise: bool = False      # ADD_BGD_NOISE street-noise mixing
    bgd_noise_ratio: float = 0.3     # predata_multiAims_noisedB.py:198-222

    # ---- model (config.py:98-102; TDAA_beta/main_run_sstune_TestVer.py) --
    hidden_units: int = 300
    num_layers: int = 2
    embedding_size: int = 50
    encoder_rnn: str = "gru"         # gru | lstm  (MIX_SPEECH recurrence)
    encoder_layers: int = 2          # TDAA uses 4 (TestVer:284-310)
    classifier_rnn: str = "lstm"
    classifier_layers: int = 2
    classifier_hidden_mult: int = 1  # TDAA widens to 2x (TestVer:324-332)
    mask_head: str = "dot"           # dot | align (ATTENTION mode)
    is_complex_mask: bool = False    # is_ComlexMask (TDAA cRM path)
    is_self_tune: bool = False       # is_SelfTune (ADDJUST residual query)
    use_discriminator: bool = False  # TDAA adversarial refinement
    crm_k: float = 10.0              # cRM tanh compression K
    crm_c: float = 0.1               # cRM tanh compression C
    num_speakers: int = 103          # WSJ0 train speaker inventory + unk
    unk_spk: bool = False
    ground_truth: bool = True        # teacher-force the classifier (config.py:93)

    # ---- selection / dedup ----------------------------------------------
    alpha: float = 0.5               # top-k prob threshold (config.py:126 ALPHA)
    quchong_alpha: float = 0.15      # embedding-cosine dedup threshold
    top_k: int = 2                   # static extraction channel count
    recursive_max_steps: int = 2     # recu loop cap (main_run_multi_selfSS_recu.py:393)

    # ---- training (config.py:104-112; main_run.py:443) -------------------
    batch_size: int = 16
    batch_size_eval: int = 10
    max_epoch: int = 250
    epoch_size: int = 200
    learning_rate: float = 2e-4
    lr_schedule: str = "constant"    # constant | halve_per_epoch | halve_50 | cosine
    lr_floor: float = 1e-7           # TestVer:596-600 halving floor
    loss_mode: str = "pit"           # pit | identity (reference channel-by-id)
                                     # | si_sdr (time-domain uPIT fine-tune)
    sum_loss_weight: float = 0.0     # 0.5*sum-to-one term (disabled in ref A17)
    grad_clip_norm: float = 200.0    # Keras Nadam(clipnorm=200) (nnet.py:23)
    optimizer: str = "adam"

    # ---- numerics / TPU --------------------------------------------------
    compute_dtype: str = "float32"   # float32 | bfloat16 — mixed precision:
    # model matmuls/activations in bf16 (native MXU tiles), master params +
    # optimizer + loss math in f32 (train/steps._compute_cast). Governs the
    # joint/dense/classifier/adversarial train steps and eval inference;
    # the cRM complex path, the memory trainer's write math, and the DSP
    # matmuls always stay f32 (precision-sensitive by design).
    use_pallas_stft: bool = False    # fused Pallas frame+window+DFT kernel
    use_pallas_maskhead: bool = False  # fused proj+tanh+dot+sigmoid Pallas
    # kernel (ops/pallas_maskhead.py): the (B,T,F,E) embedding grid never
    # hits HBM. Magnitude dot-head configs only; perf presets enable it.
    use_pallas_rnn: bool = False     # fused Pallas GRU/LSTM scan kernels —
    # 1.3-1.7x faster than lax.scan at reference shapes on TPU (128-padded
    # fused gate matmuls, docs/BENCHMARKS.md); default off because CPU test
    # runs use the slow interpreter. Perf presets (bench, tdaa, torch_multi*)
    # turn it on; very wide layers auto-fall back to the scan (VMEM).
    remat: bool = False              # jax.checkpoint the encoder scan

    # ---- parallelism (mesh axes are named "data"/"model", parallel/mesh.py)
    dp_size: int = 1                 # data-parallel mesh extent
    mp_size: int = 1                 # model/tensor-parallel mesh extent

    # ---- persistence / telemetry (paths are CLI args, not config) --------
    checkpoint_every_epochs: int = 10
    out_sep_result: bool = False     # dump separated wavs (Out_Sep_Result)
    output_dir: str = "batch_output"  # wav naming contract dir

    # ---- derived ---------------------------------------------------------
    @property
    def max_len(self) -> int:
        """MAX_LEN in samples (config.py:129-130)."""
        return int(self.frame_rate * self.max_len_seconds)

    @property
    def freq_bins(self) -> int:
        return self.frame_length // 2 + 1

    @property
    def num_frames(self) -> int:
        """Frames of a max-length utterance under the centered STFT."""
        if self.center:
            return 1 + self.max_len // self.frame_shift
        return 1 + (self.max_len - self.frame_length) // self.frame_shift

    @property
    def query_dim(self) -> int:
        """Mask-head query width: doubled for cRM (SPEECH_EMBEDDING cRM fork)."""
        return self.embedding_size * (2 if self.is_complex_mask else 1)

    def validate(self) -> "Config":
        """Mode <-> dataset consistency (the reference's valid_mode_dataset,
        Torch_multi/config.py:16-27) plus basic geometry sanity. Returns
        self so call sites can chain. Raises ValueError on conflicts."""
        allowed = {
            "speech": ("WSJ0", "THCHS-30", "TIMIT", "synth"),
            "image": ("MNIST", "synth"),
            "video": ("GRID", "AVA", "synth"),
            "topdown": ("WSJ0", "THCHS-30", "TIMIT", "synth"),
        }
        if self.mode not in allowed:
            raise ValueError(f"unknown mode {self.mode!r}; one of "
                             f"{sorted(allowed)}")
        if self.dataset not in allowed[self.mode]:
            raise ValueError(
                f"dataset {self.dataset!r} is not a {self.mode} dataset "
                f"(expected one of {allowed[self.mode]}; "
                f"valid_mode_dataset, Torch_multi/config.py:16-27)")
        if self.min_mix > self.max_mix:
            raise ValueError(f"min_mix={self.min_mix} > max_mix="
                             f"{self.max_mix}")
        if self.top_k < 1 or self.frame_shift > self.frame_length:
            raise ValueError("top_k must be >=1 and frame_shift must not "
                             "exceed frame_length")
        if self.loss_mode not in ("pit", "identity", "si_sdr"):
            raise ValueError(f"unknown loss_mode {self.loss_mode!r}; one "
                             f"of ('pit', 'identity', 'si_sdr')")
        return self

    def replace(self, **kw) -> "Config":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    def log_config(self) -> str:
        """Dump every knob, mirroring log_config (Torch_multi/config.py:264-296)."""
        lines = [f"{k} = {v!r}" for k, v in sorted(dataclasses.asdict(self).items())]
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# Presets — one per reference configuration / entry-point family.
# ---------------------------------------------------------------------------

_PRESETS = {}


def _register(cfg: Config) -> Config:
    _PRESETS[cfg.name] = cfg
    return cfg


# Torch_multi/main_run.py + config.py: canonical 2-speaker self-separation.
# (production presets run the fused Pallas RNN kernels — 1.3-1.7x over the
# scan at reference shapes; debug/test presets keep the portable scan)
TORCH_MULTI = _register(Config(name="torch_multi", use_pallas_rnn=True,
                               use_pallas_stft=True, use_pallas_maskhead=True))

# Scaled beyond-reference config (no reference counterpart): 3-layer
# BiGRU-384 encoder. H=384 is an exact 128-lane multiple, so the fused
# Pallas RNN kernels run unpadded, and the bf16 projection W (9.9 MB)
# still fits the fused mask head's VMEM guard. Closes part of the gap to
# the oracle IRM bound that the reference topology (H=300 x 2) leaves
# (docs/BENCHMARKS.md real-scale rehearsal).
TORCH_MULTI_XL = _register(TORCH_MULTI.replace(
    name="torch_multi_xl", hidden_units=384, encoder_layers=3))

# Deeper still (oracle-gap sweep, docs/BENCHMARKS.md): H stays 384 — the
# widest exact-128-lane size whose bf16 projection W (9.9 MB) passes the
# fused mask head's VMEM guard — and depth goes to 4 bidirectional layers.
TORCH_MULTI_XXL = _register(TORCH_MULTI.replace(
    name="torch_multi_xxl", hidden_units=384, encoder_layers=4))

# Torch_multi/main_run_multi_selfSS_dB.py + predata_multiAims_dB: SNR-augmented,
# widened classifier.
TORCH_MULTI_DB = _register(Config(
    name="torch_multi_db", augment_data=True, classifier_hidden_mult=2,
    use_pallas_rnn=True, use_pallas_stft=True, use_pallas_maskhead=True))

# 3-speaker variant (predata_multiAims_3dB.py).
TORCH_MULTI_3DB = _register(Config(
    name="torch_multi_3db", max_mix=3, top_k=3, augment_data=True,
    classifier_hidden_mult=2, use_pallas_rnn=True, use_pallas_stft=True,
    use_pallas_maskhead=True))

# Street-noise variant (predata_multiAims_noisedB.py).
TORCH_MULTI_NOISE = _register(Config(
    name="torch_multi_noise", add_bgd_noise=True, augment_data=True,
    classifier_hidden_mult=2, use_pallas_rnn=True, use_pallas_stft=True,
    use_pallas_maskhead=True))

# TDAA_beta/config_WSJ0_dB.py + main_run_sstune_* — 4-layer BiLSTM encoder,
# self-tune ADDJUST, adversarial discriminator, wsj0-2mix lists.
TDAA = _register(Config(
    name="tdaa", mode="topdown", encoder_rnn="lstm", encoder_layers=4,
    classifier_hidden_mult=2, is_self_tune=True, use_discriminator=True,
    batch_size=16, max_epoch=600, epoch_size=10,
    lr_schedule="halve_per_epoch", augment_data=True, use_pallas_rnn=True,
    use_pallas_stft=True, use_pallas_maskhead=True))

# TDAA complex-ratio-mask path (main_run_sstune_cRM_EvalVer.py).
TDAA_CRM = _register(TDAA.replace(
    name="tdaa_crm", is_complex_mask=True, use_discriminator=False))

# TDAA recursive one-speaker-per-step extraction (main_run_sstune_RecuVer.py,
# main_run_multi_selfSS_recu.py): batch 1, peel-and-subtract.
TDAA_RECURSIVE = _register(TDAA.replace(
    name="tdaa_recursive", batch_size=1, use_discriminator=False,
    recursive_max_steps=2))

# Cocktail/software/DL4SS_Keras (config_noMat.py): target-speaker extraction
# with life-long speaker memory; TIMIT debug scale (HIDDEN 16, LAYERS 1,
# EMB 20, config_noMat.py:34-47).
COCKTAIL_DEBUG = _register(Config(
    name="cocktail_debug", dataset="TIMIT", hidden_units=16, num_layers=1,
    encoder_layers=1, embedding_size=20, batch_size=2, encoder_rnn="lstm",
    unk_spk=True))

# Cocktail at production scale (the config.cfg-overridden path).
COCKTAIL = _register(Config(
    name="cocktail", dataset="WSJ0", encoder_rnn="lstm", unk_spk=True,
    use_pallas_rnn=True, use_pallas_stft=True))

# Multi_modal image-query variant (MNIST digit ↔ speaker id).
MULTIMODAL_IMAGE = _register(Config(
    name="multimodal_image", mode="image", dataset="MNIST",
    encoder_rnn="lstm", unk_spk=True))

# GRID audio-visual variant (Torch_multi/predata.py lip frames).
GRID_VIDEO = _register(Config(
    name="grid_video", mode="video", dataset="GRID", encoder_rnn="gru",
    use_pallas_rnn=True, use_pallas_stft=True, use_pallas_maskhead=True))

# Fast test/bench preset — tiny synthetic data, real model shapes.
SYNTH_TINY = _register(Config(
    name="synth_tiny", dataset="synth", num_speakers=8, batch_size=4,
    max_len_seconds=0.5, hidden_units=32, embedding_size=16,
    encoder_layers=1, classifier_layers=1, epoch_size=2, max_epoch=2))

# Flagship bench preset — reference workload shape, bf16 compute, fused
# Pallas RNN kernels (1.3-1.7x over lax.scan at this shape).
BENCH = _register(Config(
    name="bench", dataset="synth", batch_size=16, compute_dtype="bfloat16",
    use_pallas_stft=True, use_pallas_rnn=True, use_pallas_maskhead=True))


def preset(name: str) -> Config:
    """Look up a named preset (the rebuild's `import config_X as config`)."""
    try:
        return _PRESETS[name]
    except KeyError:
        raise KeyError(
            f"unknown preset {name!r}; available: {sorted(_PRESETS)}") from None


def preset_names() -> Tuple[str, ...]:
    return tuple(sorted(_PRESETS))
