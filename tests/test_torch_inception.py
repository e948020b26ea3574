"""The port's Inception-v3 trunk (ROADMAP P12) against the JAX package's on
the CPU: the forward with the aux head from a random JAX init
(`load_jax_params`), the torchvision state-dict loader against JAX's on a
state dict built here with torchvision's key names (torchvision is not
installed and no weights are in the repository), and the trunk frozen in
a video-query train step."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from dl4ss_tpu.models import inception as jinc
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data.synth import make_synthetic_bank
from dl4ss_tpu_torch.models import inception as tinc
from dl4ss_tpu_torch.train import query_trainer as tqt
from dl4ss_tpu_torch.weights import flatten_tree, load_jax_params


def test_inception_forward_with_the_aux_head_matches_jax():
    """One 299x299 frame (the smallest the aux head takes: its 5x5 pool
    at stride 3 and 5x5 conv need Mixed_6e's 17x17): logits, aux logits
    and the 2048-d penultimate within 1e-4."""
    p = jinc.init_inception_v3(jax.random.PRNGKey(0))
    model = load_jax_params(tinc.InceptionV3(device="cpu"),
                            jax.tree_util.tree_map(np.asarray, p))
    x = np.random.default_rng(0).uniform(-1, 1, (1, 299, 299, 3)).astype(
        np.float32)
    ref = jinc.apply_inception_v3(p, jnp.asarray(x), aux=True)
    with torch.no_grad():
        ours = tinc.apply_inception_v3(model, torch.as_tensor(x), aux=True)
    for a, r in zip(ours, ref):
        assert tuple(a.shape) == r.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(r), atol=1e-4)


def _torchvision_state_dict(rng):
    """A random state dict under torchvision's inception_v3 key names: per
    BasicConv2d `<m>.conv.weight` (O, I, H, W) and `<m>.bn.{weight, bias,
    running_mean, running_var}`, per Linear `<m>.weight` (O, I) and
    `<m>.bias`."""
    sd = {}
    for name, p in tinc.InceptionV3(device="cpu").named_parameters():
        mod, leaf = name.rsplit(".", 1)
        if leaf == "w" and p.dim() == 4:
            kh, kw, i, o = p.shape
            sd[f"{mod}.conv.weight"] = rng.standard_normal((o, i, kh, kw))
            sd[f"{mod}.bn.weight"] = rng.uniform(0.5, 1.5, o)
            sd[f"{mod}.bn.bias"] = rng.standard_normal(o)
            sd[f"{mod}.bn.running_mean"] = rng.standard_normal(o)
            sd[f"{mod}.bn.running_var"] = rng.uniform(0.5, 2.0, o)
        elif leaf == "w":
            sd[f"{mod}.weight"] = rng.standard_normal(p.shape[::-1])
            sd[f"{mod}.bias"] = rng.standard_normal(p.shape[1])
    return {k: torch.as_tensor(v.astype(np.float32)) for k, v in sd.items()}


def test_torchvision_state_dict_loads_as_jax_loads_it(tmp_path):
    """`load_torch_state_dict` of one torchvision-named state dict: the
    same tree as JAX's, leaf for leaf (BN folded with eps 1e-3); it loads
    into the port's module, and from a .pth file alike."""
    sd = _torchvision_state_dict(np.random.default_rng(1))
    ours = dict(flatten_tree(tinc.load_torch_state_dict(sd)))
    ref = dict(flatten_tree(jax.tree_util.tree_map(
        np.asarray, jinc.load_torch_state_dict(
            {k: v.numpy() for k, v in sd.items()}))))
    n_conv = sum(k.endswith(".conv.weight") for k in sd)
    assert ours.keys() == ref.keys() and len(ours) == 3 * n_conv + 4
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, atol=0,
                                   err_msg=k)
    torch.save(sd, tmp_path / "inception_v3.pth")
    model = load_jax_params(tinc.InceptionV3(device="cpu"),
                            tinc.load_torch_state_dict(
                                str(tmp_path / "inception_v3.pth")))
    assert torch.equal(model.Mixed_7c["branch_pool"].w,
                       torch.as_tensor(ours["Mixed_7c.branch_pool.w"]))


def test_inception_trunk_is_frozen_in_a_video_query_step():
    """One grid_video query step with the Inception trunk (75x75 frames,
    the smallest its stem takes, no aux head): the trunk's parameters do
    not move and their Adam moments stay zero, as JAX's stop_gradient
    leaves them; the query head and the separator move."""
    cfg = preset("grid_video").replace(
        hidden_units=16, embedding_size=6, max_len_seconds=0.25,
        num_speakers=4, batch_size=1, num_layers=1, encoder_layers=1,
        use_pallas_rnn=False, use_pallas_stft=False,
        use_pallas_maskhead=False)
    state = tqt.create_query_state(cfg, 0, video_trunk="inception",
                                   frame_hw=(75, 75), device="cpu")
    before = {n: p.detach().clone()
              for n, p in state.model.named_parameters()}
    rng = np.random.default_rng(2)
    bank = torch.as_tensor(make_synthetic_bank(0, 4, 2, cfg.max_len))
    frames = torch.as_tensor(rng.uniform(0, 1, (4, 1, 2, 75, 75, 3)).astype(
        np.float32))
    feats = tqt.query_batch(torch.Generator().manual_seed(0), bank, cfg,
                            "query_video", frames)
    state, metrics = tqt.make_query_train_step(cfg)(state, feats)
    assert np.isfinite(float(metrics["loss"]))
    named = list(state.model.named_parameters())
    trunk = [i for i, (n, _) in enumerate(named)
             if n.startswith("video_query.inception.")]
    assert len(trunk) == len(list(tinc.InceptionV3(device="cpu")
                                  .parameters()))
    for i in trunk:
        name, p = named[i]
        assert torch.equal(p, before[name]), name
        assert not torch.any(state.opt_state.mu[i]), name
        assert not torch.any(state.opt_state.nu[i]), name
    for name in ("video_query.dense.w", "video_query.rnn.0.fwd.wx",
                 "encoder.proj.w"):
        assert not torch.equal(dict(named)[name], before[name]), name
