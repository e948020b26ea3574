"""Life-long speaker memory as explicit state (the port of
`dl4ss_tpu/models/memory.py`).

One tensor pair that lives beside the train state and is updated after
each step (the Keras out-of-graph `update_memory` write,
Cocktail/.../extend_layers.py:220-228, and the torch MEMORY list,
Torch_multi/main_run.py:67-181):

  * vectors (S, 3, D) f32: one D-dim vector per speaker per modality slot
    (voice / image / video);
  * age (S, 3) int32: per-slot write counts.

Write semantics are selectable:
  * "keras": L2-normalize the incoming vector (eps-guarded,
    extend_layers.py:160-166), add it into the row, then renormalize the
    whole row (SpkLifeLongMemory's inc_subtensor update);
  * "torch": final = (old + new) / ||old + new||_2 (MEMORY.updata_vector,
    main_run.py:129-140).

Every function is out of place, so a write inside the graph passes its
gradient to the incoming vectors. Duplicate speaker ids in one batch
accumulate, as JAX's `.at[].add` does; the rows are summed as a one-hot
(B, S) product, not by `index_add_`, whose CUDA atomics would add the
duplicates in another order on every run (a resumed run must equal an
unbroken one bit for bit). The write counts are the one-hot's column
sums, not `bincount`, which on the card reads the largest id back to the
host to size its output. Under data parallelism (parallel/mesh.py) each
rank holds a share of the batch: the product and the write counts are
summed over the data group, so that a speaker whose utterances fall on
two ranks gets both contributions, as in the global batch.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

SLOT_SPEECH, SLOT_IMAGE, SLOT_VIDEO = 0, 1, 2
# the reference's zero guard, np.spacing(1) in f32 (extend_layers.py:161)
_SPACING = float(np.spacing(np.float32(1.0)))


class MemorySlots(NamedTuple):
    vectors: torch.Tensor  # (S, 3, D) float32
    age: torch.Tensor      # (S, 3) int32


def memory_rows(cfg) -> int:
    """Memory row count for a Config: the speaker inventory plus the
    reserved unk row when cfg.unk_spk (extend_layers.py:133-136)."""
    return cfg.num_speakers + (1 if cfg.unk_spk else 0)


def init_memory(num_speakers: int, dim: int, device=None) -> MemorySlots:
    return MemorySlots(
        vectors=torch.zeros((num_speakers, 3, dim), dtype=torch.float32,
                            device=device),
        age=torch.zeros((num_speakers, 3), dtype=torch.int32, device=device))


def _safe_l2(v: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """L2 norm with the reference's zero guard (exact zeros count as
    np.spacing(1), extend_layers.py:161)."""
    v = torch.where(v == 0.0, torch.full_like(v, _SPACING), v)
    return torch.sqrt(torch.sum(v * v, dim=dim, keepdim=True))


def _one_hot(spk_idx: torch.Tensor, rows: int, dtype) -> torch.Tensor:
    return F.one_hot(spk_idx.long(), rows).to(dtype)            # (B, S)


def _with_slot(vectors: torch.Tensor, slot: int, new: torch.Tensor
               ) -> torch.Tensor:
    """`vectors` with slot `slot` replaced by `new` (S, D), out of place."""
    return torch.stack([new if s == slot else vectors[:, s]
                        for s in range(vectors.shape[1])], dim=1)


def memory_write_slot(state: MemorySlots, spk_idx: torch.Tensor,
                      vec: torch.Tensor, slot: int = SLOT_SPEECH,
                      mode: str = "keras", mesh=None) -> MemorySlots:
    """Batched write: spk_idx (B,) int, vec (B, D) -> new state.

    Duplicate indices within the batch accumulate (inc_subtensor
    semantics). With a `mesh` (a parallel.mesh.Mesh) the batch is this
    rank's share of the global one, and the sums run over its data group
    (the gradient's too)."""
    def batch_sum(x):
        return x if mesh is None else mesh.data_sum(x)

    old = state.vectors[:, slot, :]
    onehot = _one_hot(spk_idx, old.shape[0], old.dtype)
    # writes per row, exact in float32 up to 2^24 rows of a batch
    counts = batch_sum(onehot.sum(dim=0))
    if mode == "keras":
        incoming = vec / _safe_l2(vec)
        new = old + batch_sum(onehot.t() @ incoming)
        new = new / _safe_l2(new)
    elif mode == "torch":
        summed = old + batch_sum(onehot.t() @ vec)
        norm = torch.linalg.vector_norm(summed, dim=-1, keepdim=True)
        new = torch.where(norm > 0, summed / torch.clamp(norm, min=1e-12),
                          summed)
        # only touched rows renormalize in the reference
        new = torch.where((counts > 0)[:, None], new, old)
    else:
        raise ValueError(f"unknown memory mode {mode!r}")
    age = state.age.clone()
    age[:, slot] += counts.to(age.dtype)
    return MemorySlots(_with_slot(state.vectors, slot, new), age)


def memory_write(state: MemorySlots, spk_idx: torch.Tensor,
                 vec: torch.Tensor, slot: int = SLOT_SPEECH,
                 mode: str = "keras") -> MemorySlots:
    """`memory_write_slot` on one device (JAX `memory_write`)."""
    return memory_write_slot(state, spk_idx, vec, slot, mode)


def memory_read(state: MemorySlots, spk_idx: torch.Tensor,
                slot: int = SLOT_SPEECH) -> torch.Tensor:
    """SelectSpkMemory gather (extend_layers.py:188-216): (B,) -> (B, D)."""
    return state.vectors[spk_idx.long(), slot, :]


def memory_reset_rows(state: MemorySlots, spk_idx: torch.Tensor
                      ) -> MemorySlots:
    """Zero the given rows (all slots): successive unknown-speaker
    enrollments start the reserved unk row afresh for each speaker
    (Cocktail/.../predict.py:48-50)."""
    keep = torch.ones(state.vectors.shape[0], dtype=torch.bool,
                      device=state.vectors.device)
    keep[spk_idx.long()] = False
    return MemorySlots(
        vectors=torch.where(keep[:, None, None], state.vectors,
                            torch.zeros_like(state.vectors)),
        age=torch.where(keep[:, None], state.age,
                        torch.zeros_like(state.age)))


def memory_extend(state: MemorySlots, extra_rows: int) -> MemorySlots:
    """Append `extra_rows` zeroed rows: batched unk-speaker evaluation
    enrolls each unknown speaker into a fresh row of its own."""
    s, slots, d = state.vectors.shape
    dev = state.vectors.device
    return MemorySlots(
        vectors=torch.cat([state.vectors,
                           torch.zeros((extra_rows, slots, d),
                                       dtype=state.vectors.dtype,
                                       device=dev)], dim=0),
        age=torch.cat([state.age,
                       torch.zeros((extra_rows, slots), dtype=state.age.dtype,
                                   device=dev)], dim=0))


def memory_from_jax(memory) -> MemorySlots:
    """A JAX `MemorySlots` (its fields as numpy arrays, or anything
    np.asarray takes) as the port's, on the CPU."""
    return MemorySlots(
        vectors=torch.as_tensor(np.array(memory.vectors, np.float32)),
        age=torch.as_tensor(np.array(memory.age, np.int32)))
