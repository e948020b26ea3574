"""The fused joint step's CUDA graph (`train.steps._GraphedJointStep`) and
what it rests on: the cached permutation table, the launch counters'
accounting and the graph's key.

The CPU tests hold the step to the eager path where the graph does not
engage (the CPU, a mesh). The tests marked `cuda` hold the graphed step to
the eager one at the `torch_multi` preset's full width; they skip without
a CUDA device. This file imports no JAX, so on a GPU machine:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_graph_step.py
"""

import itertools

import numpy as np
import pytest
import torch

from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.data.synth import featurize, sample_mixtures
from dl4ss_tpu_torch.objectives.pit import permutation_table, pit_loss
from dl4ss_tpu_torch.ops import cuda_lib
from dl4ss_tpu_torch.ops import rnn_kernels, stft_kernels
from dl4ss_tpu_torch.parallel.mesh import make_mesh, shard_batch
from dl4ss_tpu_torch.train import steps
from dl4ss_tpu_torch.train.state import create_train_state

FLAGS = dict(use_pallas_rnn=True, use_pallas_stft=True,
             use_pallas_maskhead=True)


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_permutation_table_is_itertools_order_built_once(k):
    cpu = torch.device("cpu")
    table = permutation_table(k, cpu)
    want = torch.tensor(list(itertools.permutations(range(k))))
    assert table.dtype == torch.int64 and torch.equal(table, want)
    assert permutation_table(k, cpu) is table
    pred = torch.rand(3, k, 5, 4, generator=torch.Generator().manual_seed(k))
    _, perm = pit_loss(pred, pred.flip(1))
    assert torch.equal(perm, torch.arange(k).flip(0).expand(3, k))
    assert permutation_table(k, cpu) is table


def test_uncounted_takes_launches_out_and_count_adds_them_back():
    assert cuda_lib.COUNTERS[0] is cuda_lib.LAUNCHES
    assert any(c is rnn_kernels.BODY_LAUNCHES for c in cuda_lib.COUNTERS)
    assert any(c is stft_kernels.BODY_LAUNCHES for c in cuda_lib.COUNTERS)
    before = [dict(c) for c in cuda_lib.COUNTERS]
    with cuda_lib.uncounted() as launched:
        cuda_lib.LAUNCHES["test_kernel"] += 2
        rnn_kernels.BODY_LAUNCHES["test_kernel", "resident"] += 1
    assert [dict(c) for c in cuda_lib.COUNTERS] == before
    assert launched[0] == {"test_kernel": 2}
    cuda_lib.count(launched)
    cuda_lib.count(launched)
    assert cuda_lib.LAUNCHES["test_kernel"] == 4
    assert rnn_kernels.BODY_LAUNCHES["test_kernel", "resident"] == 2
    del cuda_lib.LAUNCHES["test_kernel"]
    del rnn_kernels.BODY_LAUNCHES["test_kernel", "resident"]


def _tiny(seed=0):
    cfg = preset("synth_tiny").replace(**FLAGS)
    bank = torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 1, (cfg.num_speakers, 3, cfg.max_len)).astype(np.float32))
    return cfg, bank


def _leaves(state):
    return ([p.detach().clone() for p in state.model.parameters()]
            + [t.clone() for t in state.opt_state.mu + state.opt_state.nu])


@pytest.mark.parametrize("on_mesh", [False, True])
def test_fused_step_runs_eagerly_on_the_cpu_and_on_a_mesh(on_mesh):
    """Without a CUDA device, or with a mesh, every call runs the eager
    path, and three steps equal today's sample -> featurize -> train
    step bit for bit, losses and parameters and moments."""
    cfg, bank = _tiny()
    mesh = make_mesh(1, 1, devices=["cpu"]) if on_mesh else None
    fused = steps.make_fused_step(cfg, mesh=mesh)
    inner = steps.make_train_step(cfg, mesh=mesh)
    got = create_train_state(cfg, seed=3, device="cpu")
    want = create_train_state(cfg, seed=3, device="cpu")
    steps.GRAPH_COUNTS.clear()
    for _ in range(3):
        got, m_got = fused(got, bank)
        batch = sample_mixtures(want.generator, bank, cfg)
        want, m_want = inner(want, featurize(shard_batch(batch, mesh), cfg))
        assert list(m_got) == list(m_want)
        for k in m_want:
            assert torch.equal(m_got[k], m_want[k]), k
    assert dict(steps.GRAPH_COUNTS) == {"eager": 3}
    assert got.step == want.step == 3
    for a, b in zip(_leaves(got), _leaves(want)):
        assert torch.equal(a, b)


def test_fused_step_returns_fresh_metric_tensors():
    cfg, bank = _tiny(1)
    state = create_train_state(cfg, seed=1, device="cpu")
    fused = steps.make_fused_step(cfg)
    seen = []
    for _ in range(3):
        state, metrics = fused(state, bank)
        seen.append(metrics)
    for name in seen[0]:
        assert len({id(m[name]) for m in seen}) == len(seen)
        assert all(torch.isfinite(m[name]) for m in seen)


def test_graph_key_follows_shapes_and_addresses():
    """The key holds the batch's shapes and the model's addresses: a batch
    of another size or a parameter replaced by new tensors changes it; a
    new batch of the same shapes or an in-place restore does not."""
    cfg, bank = _tiny(2)
    state = create_train_state(cfg, seed=2, device="cpu")
    model, gen = state.model, state.generator
    key = steps._graph_key(sample_mixtures(gen, bank, cfg), model)
    assert steps._graph_key(sample_mixtures(gen, bank, cfg), model) == key
    other = sample_mixtures(gen, bank, cfg, batch_size=cfg.batch_size + 1)
    assert steps._graph_key(other, model) != key
    batch = sample_mixtures(gen, bank, cfg)
    saved = {k: v.clone() for k, v in model.state_dict().items()}
    model.load_state_dict(saved)                    # in place: same key
    assert steps._graph_key(batch, model) == key
    model.load_state_dict(saved, assign=True)       # new tensors
    assert steps._graph_key(batch, model) != key


# ---- on the card --------------------------------------------------------

@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the CUDA graph and the kernels "
                    "it replays run only there")
    from dl4ss_tpu_torch import resolve_device
    return resolve_device("cuda")


GRAPH_STEPS = 6


def _full_width(dev, seed=5):
    cfg = preset("torch_multi")
    bank = torch.as_tensor(np.random.default_rng(seed).uniform(
        -1, 1, (cfg.num_speakers, 4, cfg.max_len)).astype(np.float32),
        device=dev)
    return cfg, bank


def _zero_counts():
    torch.cuda.synchronize()
    for c in cuda_lib.COUNTERS:
        c.clear()
    steps.GRAPH_COUNTS.clear()


def _eager_run(cfg, bank, dev, n):
    """Today's path: sample -> featurize -> the eager train step."""
    state = create_train_state(cfg, seed=7, device=dev)
    inner = steps.make_train_step(cfg)
    losses = []
    for _ in range(n):
        batch = sample_mixtures(state.generator, bank, cfg)
        state, m = inner(state, featurize(batch, cfg))
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return state, torch.stack(losses)


@pytest.mark.cuda
def test_graphed_joint_step_equals_eager(dev):
    """Six steps each way from one seed and bank: the graphed step (one
    eager call, one capture, five replays) leaves every parameter and Adam
    moment and gives every loss bit for bit as the eager path, and counts
    the same kernel launches."""
    cfg, bank = _full_width(dev)
    _zero_counts()
    want, want_losses = _eager_run(cfg, bank, dev, GRAPH_STEPS)
    eager_launches = dict(cuda_lib.LAUNCHES)
    _zero_counts()
    state = create_train_state(cfg, seed=7, device=dev)
    fused = steps.make_fused_step(cfg)
    got, seen = [], []
    for _ in range(GRAPH_STEPS):
        state, m = fused(state, bank)
        got.append(m["loss"])
        seen.append(m)
    torch.cuda.synchronize()
    assert dict(steps.GRAPH_COUNTS) == {"eager": 1, "captures": 1,
                                        "replays": GRAPH_STEPS - 1}
    assert dict(cuda_lib.LAUNCHES) == eager_launches
    for name in seen[0]:    # each call's metrics are its own tensors
        assert len({m[name].data_ptr() for m in seen}) == GRAPH_STEPS
    assert torch.equal(torch.stack(got), want_losses)
    for a, b in zip(_leaves(state), _leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_graphed_step_recaptures_after_the_parameters_are_replaced(dev):
    """A parameter replaced by new tensors (`load_state_dict(...,
    assign=True)`) changes the key: the next call runs eagerly, the one
    after captures anew, and every step still equals the eager path."""
    cfg, bank = _full_width(dev, seed=6)
    want, want_losses = _eager_run(cfg, bank, dev, GRAPH_STEPS)
    _zero_counts()
    state = create_train_state(cfg, seed=7, device=dev)
    fused = steps.make_fused_step(cfg)
    got = []
    for i in range(GRAPH_STEPS):
        if i == 3:
            state.model.load_state_dict(
                {k: v.clone() for k, v in state.model.state_dict().items()},
                assign=True)
        state, m = fused(state, bank)
        got.append(m["loss"])
    torch.cuda.synchronize()
    assert dict(steps.GRAPH_COUNTS) == {"eager": 2, "captures": 2,
                                        "replays": 4}
    assert torch.equal(torch.stack(got), want_losses)
    for a, b in zip(_leaves(state), _leaves(want)):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_a_replayed_step_opens_sample_replay_and_optimizer(dev):
    """Under the profiler a replayed step opens `sample`, `replay` and
    `optimizer` once each: the phases inside the graph run no host code."""
    from torch.profiler import ProfilerActivity, profile
    cfg, bank = _full_width(dev, seed=8)
    state = create_train_state(cfg, seed=7, device=dev)
    fused = steps.make_fused_step(cfg)
    for _ in range(2):
        state, _ = fused(state, bank)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fused(state, bank)
    opened = sorted(e.name for e in prof.events()
                    if e.name.startswith("dl4ss."))
    assert opened == ["dl4ss.optimizer", "dl4ss.replay", "dl4ss.sample"]
