"""Model components: `nn.Module` parameter trees named like the JAX pytrees,
and plain `init_*` / `apply_*` functions over them."""

from dl4ss_tpu_torch.models.encoder import init_encoder, apply_encoder  # noqa: F401
from dl4ss_tpu_torch.models.embedding import init_embedding, apply_embedding  # noqa: F401
from dl4ss_tpu_torch.models.attention import init_mask_head, apply_mask_head  # noqa: F401
from dl4ss_tpu_torch.models.classifier import init_classifier  # noqa: F401
from dl4ss_tpu_torch.models.separator import (  # noqa: F401
    init_separator, separate, Separator, SeparatorOutput)
