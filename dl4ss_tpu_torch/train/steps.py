"""Training and evaluation steps (the port of `dl4ss_tpu/train/steps.py`).

Each `make_*_step(cfg, ...)` returns a function (state, batch) ->
(state, metrics). PyTorch runs eagerly, so a step is the loss, its
backward and the optimizer update in sequence; on the kernel route the
backward runs K5 and K6 (the separator) or K8 (the classifier)
(ops/rnn_kernels.py, ops/maskhead_kernels.py). A step updates the state's
model and optimizer state in place and returns the same state with its
step advanced.

The joint trainer (`make_train_step`, with the pit, identity and si_sdr
losses on magnitudes or cRM spectra, teacher-forced or classifier-selected
speakers), the fused sample -> featurize -> step (`make_fused_step`), the
dense all-speaker trainer (`make_dense_train_step`), TDAA's two-phase
adversarial trainer (`make_adversarial_step`), the classifier trainer
(`make_classifier_step`), the eval step (teacher-forced or
classifier-selected, with the complement mask; magnitude or cRM) and the
recursive eval step. The separation trainers update every parameter but
the discriminator's, which only the adversarial step's first phase moves,
with its own optimizer state.

Given a `mesh` (parallel/mesh.py), a train step runs on this rank's share
of the global batch: its gradients are averaged over the data group
before the clip, which sees their global norm, and its metrics are the
global batch's means.

Every trainer marks its phases for the profiler (`utils.profiling.span`):
`forward` from the step's inputs to its loss tensors (twice in the
adversarial step, once a phase), then `backward` and `optimizer`.

On a CUDA device and without a mesh, the fused step replays its featurize
-> forward -> backward as a CUDA graph, one per key (the batch's shapes
and dtypes, the model's tensors' addresses), with the optimizer eager
after each replay (`_GraphedJointStep`); `GRAPH_COUNTS` counts its calls.
A replay runs the same kernels on the same data as the eager step, in the
same order: only the host's work per launch leaves the step.
"""

from __future__ import annotations

import collections
import itertools
import warnings
from typing import Callable, Dict, List, NamedTuple, Optional

import torch
import torch.nn.functional as F
from torch.func import functional_call

from dl4ss_tpu_torch.config import Config
from dl4ss_tpu_torch.data.synth import (MixtureBatch, featurize,
                                        sample_mixtures)
from dl4ss_tpu_torch.eval.sisdr import si_sdr_pit
from dl4ss_tpu_torch.models.discriminator import apply_discriminator
from dl4ss_tpu_torch.models.separator import (Separator, SeparatorOutput,
                                              recursive_separate)
from dl4ss_tpu_torch.objectives.losses import (complex_mse_loss, gan_d_loss,
                                               gan_g_loss, mask_mse_loss,
                                               multilabel_softmargin_loss,
                                               sum_to_one_loss)
from dl4ss_tpu_torch.objectives.pit import pit_loss
from dl4ss_tpu_torch.ops import cuda_lib
from dl4ss_tpu_torch.ops.crm import unpack_ri
from dl4ss_tpu_torch.ops.stft import istft_cfg
from dl4ss_tpu_torch.parallel.mesh import (Mesh, mean_metrics,
                                           reduce_gradients, shard_batch)
from dl4ss_tpu_torch.train.state import (TrainState, discriminator_params,
                                         generator_params, make_optimizer)
from dl4ss_tpu_torch.utils.profiling import span


def _compute_cast(model: Separator, feats: dict, cfg: Config):
    """Mixed-precision compute (cfg.compute_dtype='bfloat16'): the model
    runs on bf16 casts of its f32 parameters and features, while the
    differentiated masters, the optimizer state and the loss math stay f32
    (the casts are differentiated back to the masters). Returns
    (bf16 parameters by name, or None for f32 compute, feats)."""
    if cfg.compute_dtype != "bfloat16" or cfg.is_complex_mask:
        return None, feats
    bf = torch.bfloat16
    params = {n: p.to(bf) if p.dtype == torch.float32 else p
              for n, p in model.named_parameters()}
    return params, dict(feats, mix_feas=feats["mix_feas"].to(bf))


def _separate(model: Separator, feats: dict, cfg: Config,
              spk_idx: Optional[torch.Tensor], need_probs: bool = False,
              channel_gate: Optional[torch.Tensor] = None
              ) -> SeparatorOutput:
    """`separate` (or, given `channel_gate`, `separate_dense`) in the
    compute dtype: on the model itself, or through `functional_call` on
    the bf16 casts of its parameters. With no `spk_idx` the classifier
    selects the speakers."""
    params, cfeats = _compute_cast(model, feats, cfg)
    args = (cfeats["mix_feas"], cfg)
    kwargs = dict(spk_idx=spk_idx, mix_ri=cfeats.get("mix_ri"),
                  need_probs=need_probs, channel_gate=channel_gate)
    if params is None:
        return model(*args, **kwargs)
    return functional_call(model, params, args, kwargs)


def _mixture_phasor(mix_ri: torch.Tensor) -> torch.Tensor:
    mix = torch.complex(mix_ri[..., 0], mix_ri[..., 1])
    return mix / torch.clamp(mix.abs(), min=1e-8)


def _separation_loss(model: Separator, feats: dict, cfg: Config):
    """Mask loss of the top-k path: pit or identity assignment of the
    masked magnitudes (or, under cfg.is_complex_mask, the cRM-masked
    complex spectra) against the clean ones, or (loss_mode='si_sdr') the
    negative live-weighted uPIT SI-SDR of the resynthesised waveforms.
    cfg.ground_truth teacher-forces the extraction channels with the true
    speakers; otherwise the classifier selects them. Selection indices
    carry no gradient, so the classifier itself trains only through
    `make_classifier_step`. The sum-to-one term is a magnitude term: cRM
    configs never add it."""
    live = feats["channel_live"].float()
    spk_idx = feats["spk_idx"] if cfg.ground_truth else None
    out = _separate(model, feats, cfg, spk_idx)
    if cfg.loss_mode == "si_sdr":
        pred = out.pred.float()
        if cfg.is_complex_mask:
            pred_spec = unpack_ri(pred)
        else:
            pred_spec = pred * _mixture_phasor(feats["mix_ri"])[:, None]
        wavs = istft_cfg(pred_spec, cfg, length=cfg.max_len)
        scores, perm = si_sdr_pit(wavs, feats["source_wavs"], live=live)
        loss = -scores.mean()
    elif cfg.is_complex_mask:
        pred = out.pred * live[..., None, None, None]
        target = feats["src_ri"]
        if cfg.loss_mode == "pit":
            loss, perm = pit_loss(pred, target)
        else:
            loss, perm = complex_mse_loss(pred, target, live), None
    else:
        pred = out.pred * live[..., None, None]
        target = feats["src_feas"]
        if cfg.loss_mode == "pit":
            loss, perm = pit_loss(pred, target)
        else:
            loss, perm = mask_mse_loss(pred, target, live), None
    aux = {"mask_loss": loss, "out": out, "perm": perm}
    if cfg.sum_loss_weight > 0 and not cfg.is_complex_mask:
        sl = sum_to_one_loss(out.masks * live[..., None, None])
        loss = loss + cfg.sum_loss_weight * sl
        aux["sum_loss"] = sl
    return loss, aux


def _gradients(loss: torch.Tensor, params) -> List[torch.Tensor]:
    """d loss / d params alone. Parameters the loss does not reach get
    zeros, as jax.grad gives them; nothing outside `params` gets a
    gradient."""
    grads = torch.autograd.grad(loss, params, allow_unused=True)
    return [torch.zeros_like(p) if g is None else g
            for p, g in zip(params, grads)]


def _backward_and_update(params, opt_state, opt, loss: torch.Tensor,
                         mesh: Optional[Mesh] = None) -> torch.Tensor:
    """Differentiate `loss` with respect to `params` (`_gradients`), apply
    one optimizer update to them and `opt_state` in place and return the
    global grad norm. With a `mesh` the gradients are averaged over its
    data group first (where XLA inserts the all-reduce in JAX), and the
    clip takes the mesh's global norm; the average is the tail of the
    `backward` span."""
    with span("backward"):
        grads = _gradients(loss, params)
        norm = None
        if mesh is not None:
            grads, norm = reduce_gradients(params, grads, mesh)
    with span("optimizer"):
        return opt.update(params, grads, opt_state, norm=norm)


def make_train_step(cfg: Config, steps_per_epoch: int = 1,
                    mesh: Optional[Mesh] = None) -> Callable:
    """The canonical joint trainer (A17/A18/A19): teacher-forced speakers,
    mask MSE (+PIT) or SI-SDR, clipped Adam. step(state, feats) ->
    (state, metrics), updating the state in place."""
    if not cfg.ground_truth and cfg.loss_mode == "identity":
        raise ValueError(
            "ground_truth=False selects channels from the classifier, so "
            "channel k no longer aligns with source k — identity assignment "
            "is ill-posed in the top-k layout; use loss_mode='pit'/'si_sdr'.")
    opt = make_optimizer(cfg, steps_per_epoch)

    def step(state: TrainState, feats: dict):
        loss, losses = _joint_loss(state.model, feats, cfg)
        grad_norm = _backward_and_update(generator_params(state.model),
                                         state.opt_state, opt, loss, mesh)
        state.step += 1
        return state, mean_metrics({**losses, "grad_norm": grad_norm}, mesh)

    return step


def _joint_loss(model: Separator, feats: dict, cfg: Config):
    """The joint trainer's forward: (the loss to differentiate, the step's
    loss metrics)."""
    with span("forward"):
        loss, aux = _separation_loss(model, feats, cfg)
    losses = {"loss": loss.detach(), "mask_loss": aux["mask_loss"].detach()}
    if "sum_loss" in aux:
        losses["sum_loss"] = aux["sum_loss"].detach()
    return loss, losses


# The fused step's calls by how they ran: `eager`, or on a CUDA graph, which
# a call first `captures` (and replays once) and later calls `replays`.
GRAPH_COUNTS: collections.Counter = collections.Counter()
MAX_GRAPHS = 4      # graphs a fused step keeps; a call past them runs eagerly


class _StepGraph(NamedTuple):
    graph: "torch.cuda.CUDAGraph"
    batch: MixtureBatch          # the inputs a replay reads
    losses: Dict[str, torch.Tensor]
    grads: List[torch.Tensor]    # what a replay writes
    launched: list               # the kernels a replay runs (`uncounted`)


def _graph_key(batch: MixtureBatch, model: Separator) -> tuple:
    """What a captured graph holds fixed: the batch's shapes, dtypes and
    device, and the addresses of the model's parameters and buffers."""
    return (tuple((x.device, x.shape, x.dtype) for x in batch
                  if x is not None),
            tuple((t.data_ptr(), t.shape, t.dtype) for t in
                  itertools.chain(model.parameters(), model.buffers())))


class _GraphedJointStep:
    """The device part of the fused joint step, featurize -> forward ->
    backward, as CUDA graphs. The first call on a key runs eagerly; the
    second warms the region up on a side stream on its own batch (which
    changes no state), captures it and replays it; later calls copy their
    batch into the graph's inputs and replay. Each replay adds the launches
    its capture recorded to the launch counters (`cuda_lib.count`); the
    warm-up and the capture count none. The optimizer runs eagerly on the
    graph's gradients after each replay: its learning rate and bias
    corrections are Python numbers that change every step. A call returns
    None where the step has to run eagerly: on a new key, past MAX_GRAPHS
    keys, while a parameter has a gradient hook (a replay would skip it),
    or on a key whose region could not be captured."""

    def __init__(self, cfg: Config, opt):
        self.cfg, self.opt = cfg, opt
        self.graphs: Dict[tuple, Optional[_StepGraph]] = {}
        self.seen: Dict[tuple, None] = {}     # keys run eagerly once
        self.stream = None                    # warm-up and capture

    def _region(self, model: Separator, params, batch: MixtureBatch):
        loss, losses = _joint_loss(model, featurize(batch, self.cfg),
                                   self.cfg)
        with span("backward"):
            return losses, _gradients(loss, params)

    def _capture(self, model: Separator, params, batch: MixtureBatch
                 ) -> Optional[_StepGraph]:
        static = MixtureBatch(*(None if x is None else x.clone()
                                for x in batch))
        if self.stream is None:
            self.stream = torch.cuda.Stream(batch.mix_wav.device)
        self.stream.wait_stream(torch.cuda.current_stream(
            batch.mix_wav.device))
        with cuda_lib.uncounted(), torch.cuda.stream(self.stream):
            self._region(model, params, static)
        graph = torch.cuda.CUDAGraph()
        try:
            with cuda_lib.uncounted() as launched, \
                    torch.cuda.graph(graph, stream=self.stream):
                losses, grads = self._region(model, params, static)
        except RuntimeError as err:
            warnings.warn(f"the joint step runs eagerly: its region could "
                          f"not be captured as a CUDA graph ({err})")
            return None
        GRAPH_COUNTS["captures"] += 1
        return _StepGraph(graph, static, losses, grads, launched)

    def __call__(self, state: TrainState, batch: MixtureBatch):
        model = state.model
        params = generator_params(model)
        key = _graph_key(batch, model)
        if any(p._backward_hooks for p in params):
            graph = None
        elif key in self.graphs:
            graph = self.graphs[key]
            if graph is not None:
                for dst, src in zip(graph.batch, batch):
                    if dst is not None:
                        dst.copy_(src)
        elif key in self.seen and len(self.graphs) < MAX_GRAPHS:
            graph = self.graphs[key] = self._capture(model, params, batch)
        else:
            graph = None
        if graph is None:
            self.seen[key] = None
            if len(self.seen) > 4 * MAX_GRAPHS:
                del self.seen[next(iter(self.seen))]
            return None
        with span("replay"):
            graph.graph.replay()
        GRAPH_COUNTS["replays"] += 1
        cuda_lib.count(graph.launched)
        losses = {k: v.clone() for k, v in graph.losses.items()}
        with span("optimizer"):
            grad_norm = self.opt.update(params, graph.grads, state.opt_state)
        state.step += 1
        return state, {**losses, "grad_norm": grad_norm}


def make_fused_step(cfg: Config, steps_per_epoch: int = 1,
                    noise_bank: Optional[torch.Tensor] = None,
                    mesh: Optional[Mesh] = None) -> Callable:
    """Synthesis + STFT + train: step(state, bank) -> (state, metrics).
    The batch is drawn from the state's generator; on the kernel route the
    features come from K1 (the reference's CPU generator -> numpy STFT ->
    H2D copy -> GPU step, run on the device). `noise_bank` (W, N) enables
    the street-noise augment (A5) under cfg.add_bgd_noise. With a `mesh`
    every rank draws the global batch (the generator is the same on all)
    and featurizes and trains on its own rows. On a CUDA device without a
    mesh the device part of the step replays as a CUDA graph
    (`_GraphedJointStep`); the metrics are fresh tensors either way."""
    inner = make_train_step(cfg, steps_per_epoch, mesh)
    graphed = (_GraphedJointStep(cfg, make_optimizer(cfg, steps_per_epoch))
               if mesh is None else None)

    def step(state: TrainState, bank: torch.Tensor):
        batch = sample_mixtures(state.generator, bank, cfg,
                                noise_bank=noise_bank)
        if graphed is not None and bank.is_cuda:
            done = graphed(state, batch)
            if done is not None:
                return done
        GRAPH_COUNTS["eager"] += 1
        return inner(state, featurize(shard_batch(batch, mesh), cfg))

    return step


def make_classifier_step(cfg: Config, steps_per_epoch: int = 1,
                         mesh: Optional[Mesh] = None) -> Callable:
    """The standalone classifier trainer (A26/B16):
    MultiLabelSoftMarginLoss on 'who is in the mixture'. step(state, feats)
    -> (state, {loss, element_acc}), updating the state in place. Only the
    classifier gets a gradient; the optimizer still steps every parameter
    (with zeros) but the discriminator's, as in JAX."""
    opt = make_optimizer(cfg, steps_per_epoch)

    def step(state: TrainState, feats: dict):
        with span("forward"):
            b = feats["mix_feas"].shape[0]
            dev = feats["mix_feas"].device
            live = feats["channel_live"].to(torch.bool)
            target = torch.zeros((b, cfg.num_speakers), device=dev)
            rows = torch.arange(b, device=dev)[:, None].expand_as(live)
            target[rows[live], feats["spk_idx"][live]] = 1.0
            params, cfeats = _compute_cast(state.model, feats, cfg)
            clf = state.model.classifier
            args, kwargs = (cfeats["mix_feas"], cfg), dict(logits=True)
            if params is None:
                logits = clf(*args, **kwargs)
            else:
                prefix = "classifier."
                logits = functional_call(
                    clf, {n[len(prefix):]: p for n, p in params.items()
                          if n.startswith(prefix)}, args, kwargs)
            logits = logits.float()                   # f32 loss math
            loss = multilabel_softmargin_loss(logits, target)
        _backward_and_update(generator_params(state.model), state.opt_state,
                             opt, loss, mesh)
        with torch.no_grad():
            pred = (torch.sigmoid(logits) > cfg.alpha).float()
            acc = (pred == target).float().mean()
        state.step += 1
        return state, mean_metrics({"loss": loss.detach(),
                                    "element_acc": acc}, mesh)

    return step


def make_dense_train_step(cfg: Config, steps_per_epoch: int = 1,
                          mesh: Optional[Mesh] = None) -> Callable:
    """Exact-reference channel layout: every speaker owns a loss channel
    (main_run.py:473-506); targets scattered by speaker id, all-channel
    MSE (complex MSE on the cRM layout, main_run_sstune_cRM_EvalVer.py:
    552-568), plus the sum-to-one term when cfg.sum_loss_weight > 0.
    step(state, feats) -> (state, {loss, mask_loss[, sum_loss]})."""
    opt = make_optimizer(cfg, steps_per_epoch)

    def step(state: TrainState, feats: dict):
        with span("forward"):
            b, t, f = feats["mix_feas"].shape
            dev = feats["mix_feas"].device
            live = feats["channel_live"].float()
            spk_idx = feats["spk_idx"]
            rows = torch.arange(b, device=dev)[:, None].expand_as(spk_idx)
            gate = torch.zeros((b, cfg.num_speakers), device=dev)
            gate = gate.scatter_reduce(1, spk_idx, live, reduce="amax")
            if cfg.is_complex_mask:
                target = torch.zeros((b, cfg.num_speakers, t, f, 2),
                                     device=dev)
                src = feats["src_ri"] * live[..., None, None, None]
            else:
                target = torch.zeros((b, cfg.num_speakers, t, f), device=dev)
                src = feats["src_feas"] * live[..., None, None]
            target = target.index_put((rows, spk_idx), src.float(),
                                      accumulate=True)
            out = _separate(state.model, feats, cfg, None, channel_gate=gate)
            if cfg.is_complex_mask:
                mask_l = complex_mse_loss(out.pred, target)
            else:
                mask_l = mask_mse_loss(out.pred, target)
            metrics = {"mask_loss": mask_l.detach()}
            loss = mask_l
            if cfg.sum_loss_weight > 0 and not cfg.is_complex_mask:
                # the masks are already zero-gated, so the channel sum is the
                # reference's gated sum (:508-513)
                sl = sum_to_one_loss(out.masks)
                loss = loss + cfg.sum_loss_weight * sl
                metrics["sum_loss"] = sl.detach()
        _backward_and_update(generator_params(state.model), state.opt_state,
                             opt, loss, mesh)
        state.step += 1
        return state, mean_metrics({"loss": loss.detach(), **metrics}, mesh)

    return step


def make_adversarial_step(cfg: Config, steps_per_epoch: int = 1,
                          mesh: Optional[Mesh] = None) -> Callable:
    """TDAA's two-phase adversarial trainer (B9 dis-ss / B10 dis-sp):
    phase 1 trains the discriminator on real-vs-predicted spectrograms
    (MSE-GAN) with its own optimizer state, phase 2 the separator with mask
    loss + sum-to-one + the fooling term (main_run_sstune_dis.py:615-700).
    Phase 1 differentiates the discriminator alone (the separator's output
    is a detached sample); phase 2 the generator's parameters alone, so
    the discriminator moves once a step. `real` is the clean target
    spectra (dis-ss) unless feats carries "real_specs", different-utterance
    same-speaker spectra (dis-sp, predata_fromList_dis.py:37-66)."""
    if not cfg.ground_truth and cfg.loss_mode == "identity":
        raise ValueError(
            "ground_truth=False selects channels from the classifier — "
            "identity assignment is ill-posed in the top-k layout; use "
            "loss_mode='pit'/'si_sdr' (same constraint as make_train_step)")
    g_opt = make_optimizer(cfg, steps_per_epoch)
    d_opt = make_optimizer(cfg, steps_per_epoch)
    # the generator loss carries its own sum-to-one term (weight 0.5 per
    # the reference, main_run_sstune_dis.py:683-700): strip it from
    # _separation_loss so a nonzero cfg.sum_loss_weight is not counted twice
    sum_w = cfg.sum_loss_weight if cfg.sum_loss_weight > 0 else 0.5
    sep_cfg = cfg.replace(sum_loss_weight=0.0)

    def step(state: TrainState, feats: dict):
        model = state.model

        # ---- phase 1: discriminator ----
        with span("forward"):
            live = feats["channel_live"].float()
            real = feats.get("real_specs", feats["src_feas"])
            with torch.no_grad():
                out = _separate(model, feats, cfg, feats["spk_idx"])
                fake = (out.pred * live[..., None, None]).float()
            score_real = apply_discriminator(model.discriminator, real, cfg)
            score_fake = apply_discriminator(model.discriminator, fake, cfg)
            d_loss = gan_d_loss(score_real, score_fake)
        _backward_and_update(discriminator_params(model), state.d_opt_state,
                             d_opt, d_loss, mesh)

        # ---- phase 2: generator ----
        with span("forward"):
            mask_l, aux = _separation_loss(model, feats, sep_cfg)
            pred = aux["out"].pred * live[..., None, None]
            score = apply_discriminator(model.discriminator, pred, cfg)
            sum_l = sum_to_one_loss(aux["out"].masks * live[..., None, None])
            g_loss = mask_l + sum_w * sum_l + gan_g_loss(score)
        _backward_and_update(generator_params(model), state.opt_state, g_opt,
                             g_loss, mesh)
        state.step += 1
        return state, mean_metrics({
            "d_loss": d_loss.detach(), "g_loss": g_loss.detach(),
            "mask_loss": mask_l.detach(), "sum_loss": sum_l.detach(),
            "d_acc_real": (score_real > 0.5).float().mean(),
            "d_acc_fake": (score_fake < 0.5).float().mean()}, mesh)

    return step


def _mixture_magnitude(feats: dict, cfg: Config) -> torch.Tensor:
    """The LINEAR multiplicand of the masks (matches `_finish`'s choice)."""
    if cfg.log_spectral:
        ri = feats["mix_ri"]
        return torch.sqrt(ri[..., 0] ** 2 + ri[..., 1] ** 2)
    return feats["mix_feas"]


def make_recursive_eval_step(cfg: Config) -> Callable:
    """Recursive-extraction scoring (the RecuVer protocol): peel one
    speaker per step with `recursive_separate`, resynthesise each peeled
    spectrum with the mixture phase, and score permutation-resolved SI-SDR
    against the clean sources. step(model, feats) -> {pred_wavs, si_sdr,
    perm, spk_steps}; feats may carry `candidates` (B, S), the per-sample
    roster every peel step is restricted to."""

    def step(model: Separator, feats: dict):
        with torch.no_grad():
            extracted, spks = recursive_separate(
                model, feats["mix_feas"], cfg,
                allowed=feats.get("candidates"))
            pred_spec = (extracted.float()
                         * _mixture_phasor(feats["mix_ri"])[:, None])
            wavs = istft_cfg(pred_spec, cfg, length=cfg.max_len)
            refs = feats["source_wavs"]
            live = feats.get("channel_live")
            k_ref, steps = refs.shape[1], wavs.shape[1]
            if steps < k_ref:
                # fewer peel steps than reference channels: pad silent
                # estimate channels (they score against the dead refs)
                wavs = F.pad(wavs, (0, 0, 0, k_ref - steps))
            elif steps > k_ref:
                # more steps than refs: pad the refs with dead channels so
                # PIT stays square; live-masking keeps them out of the mean
                refs = F.pad(refs, (0, 0, 0, steps - k_ref))
                if live is None:
                    live = torch.ones((refs.shape[0], k_ref),
                                      dtype=torch.bool, device=refs.device)
                live = F.pad(live.to(torch.bool), (0, steps - k_ref))
            scores, perm = si_sdr_pit(wavs, refs, live=live)
        return {"pred_wavs": wavs, "si_sdr": scores, "perm": perm,
                "spk_steps": spks}

    return step


def make_eval_step(cfg: Config) -> Callable:
    """Inference + resynthesis + SI-SDR: step(model, feats) -> {pred_wavs,
    si_sdr (B,), perm, probs}. The compute dtype governs the forward; the
    masks are applied and scored in f32.

    `teacher_forced=False` lets the classifier select the speakers.
    `complement_mask`: when the classifier finds only one speaker above
    alpha in a 2-mix eval, the second channel's mask becomes 1 - mask_1,
    the reference's complement trick (main_run_sstune_TestVer.py:473-476);
    magnitude masks only. cRM configs resynthesise the predicted complex
    spectra themselves.
    """

    def step(model: Separator, feats: dict, teacher_forced: bool = True,
             complement_mask: bool = False):
        with torch.no_grad():
            out = _separate(model, feats, cfg,
                            feats["spk_idx"] if teacher_forced else None,
                            need_probs=complement_mask)
            pred, probs = out.pred.float(), out.probs.float()
            if (complement_mask and not cfg.is_complex_mask
                    and cfg.top_k == 2):
                one_spk = (probs > cfg.alpha).sum(dim=-1) <= 1     # (B,)
                comp = ((1.0 - out.masks[:, 0].float())
                        * _mixture_magnitude(feats, cfg))
                pred = pred.clone()
                pred[:, 1] = torch.where(one_spk[:, None, None], comp,
                                         pred[:, 1])
            if cfg.is_complex_mask:
                pred_spec = unpack_ri(pred)
            else:
                pred_spec = pred * _mixture_phasor(feats["mix_ri"])[:, None]
            wavs = istft_cfg(pred_spec, cfg, length=cfg.max_len)
            scores, perm = si_sdr_pit(wavs, feats["source_wavs"],
                                      live=feats.get("channel_live"))
        return {"pred_wavs": wavs, "si_sdr": scores, "perm": perm,
                "probs": probs}

    return step
