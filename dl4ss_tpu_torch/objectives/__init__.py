"""Training objectives: uPIT assignment, the reference's losses and the
speaker selection. The names below are those `dl4ss_tpu.objectives`
exports."""

from dl4ss_tpu_torch.objectives.losses import (  # noqa: F401
    mask_mse_loss, sum_to_one_loss, complex_mse_loss,
    multilabel_softmargin_loss, gan_d_loss, gan_g_loss)
from dl4ss_tpu_torch.objectives.pit import pit_loss, pit_permute  # noqa: F401
from dl4ss_tpu_torch.objectives.select import (  # noqa: F401
    top_k_mask, top_k_indices, cosine_dedup_select)
