"""Model components: `nn.Module` parameter trees named like the JAX pytrees,
and plain `init_*` / `apply_*` functions over them."""

from dl4ss_tpu_torch.models.encoder import init_encoder, apply_encoder  # noqa: F401
from dl4ss_tpu_torch.models.embedding import init_embedding, apply_embedding  # noqa: F401
from dl4ss_tpu_torch.models.attention import init_mask_head, apply_mask_head  # noqa: F401
from dl4ss_tpu_torch.models.classifier import (  # noqa: F401
    init_classifier, apply_classifier)
from dl4ss_tpu_torch.models.adjust import init_adjust, apply_adjust  # noqa: F401
from dl4ss_tpu_torch.models.discriminator import (  # noqa: F401
    init_discriminator, apply_discriminator)
from dl4ss_tpu_torch.models.separator import (  # noqa: F401
    init_separator, separate, separate_dense, recursive_separate,
    classify_speakers, Separator, SeparatorOutput)
