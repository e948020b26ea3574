"""Model components: `nn.Module` parameter trees named like the JAX pytrees,
and plain `init_*` / `apply_*` functions over them."""

from dl4ss_tpu_torch.models.encoder import init_encoder, apply_encoder  # noqa: F401
from dl4ss_tpu_torch.models.embedding import (  # noqa: F401
    init_embedding, apply_embedding, apply_embedding_gated)
from dl4ss_tpu_torch.models.attention import init_mask_head, apply_mask_head  # noqa: F401
from dl4ss_tpu_torch.models.classifier import (  # noqa: F401
    init_classifier, apply_classifier)
from dl4ss_tpu_torch.models.adjust import init_adjust, apply_adjust  # noqa: F401
from dl4ss_tpu_torch.models.discriminator import (  # noqa: F401
    init_discriminator, apply_discriminator)
from dl4ss_tpu_torch.models.memory import (  # noqa: F401
    init_memory, memory_write, memory_read, memory_write_slot, MemorySlots)
from dl4ss_tpu_torch.models.query import (  # noqa: F401
    init_image_query, apply_image_query, init_speech_query, apply_speech_query,
    init_video_query, apply_video_query, masked_mean_pool)
from dl4ss_tpu_torch.models.separator import (  # noqa: F401
    init_separator, separate, separate_dense, recursive_separate,
    classify_speakers, Separator, SeparatorOutput)
from dl4ss_tpu_torch.models.dprnn import DPRNN, DPRNNConfig  # noqa: F401
