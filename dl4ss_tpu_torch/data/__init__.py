"""Data sources: wav I/O and resampling, the synthetic bank and mixture
synthesis, speaker trees, the wsj0-mix lists, the native loader's banks,
the device prefetch and the rehearsal-corpus generator. The names below
are those `dl4ss_tpu.data` exports."""

from dl4ss_tpu_torch.data.wavio import read_wav, write_wav  # noqa: F401
from dl4ss_tpu_torch.data.resample import resample_poly_kaiser  # noqa: F401
from dl4ss_tpu_torch.data.synth import (  # noqa: F401
    MixtureBatch, make_synthetic_bank, normalize_utterance, sample_mixtures,
    featurize)
from dl4ss_tpu_torch.data.wsj0mix import (  # noqa: F401
    parse_mix_list, Wsj0MixEntry)
from dl4ss_tpu_torch.data.dirtree import (  # noqa: F401
    scan_speaker_tree, DirTreeSampler, StreamingTreeSampler)
from dl4ss_tpu_torch.data.listsampler import (  # noqa: F401
    Wsj0MixSampler, mix_from_list)
from dl4ss_tpu_torch.data.loader import device_prefetch  # noqa: F401
