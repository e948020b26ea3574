"""The port's parallel layout (ROADMAP P13) against the JAX package's, on the
CPU: the host-shard arithmetic, the mesh and its sharding rules, the
trainers' layout checks (no process group needed); one joint and one
memory step on a dp=2 mesh of two gloo ranks against JAX's steps on a
dp=2 mesh of its CPU devices (the memory step with a speaker whose
utterances fall on both ranks); `run.train --dp 2` and `--dp 1 --mp 2`
against the single-device run, as tests/test_sharding.py holds JAX's; and
the utils; `run.train` under torchrun, which joins the launcher's group.
Every test that starts ranks bounds them with a timeout."""

import json
import os
import signal
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_parallel_workers as workers
from dl4ss_tpu import preset as jax_preset
from dl4ss_tpu.data.synth import featurize as jax_featurize
from dl4ss_tpu.data.synth import linear_target_mags as jax_target_mags
from dl4ss_tpu.data.synth import make_synthetic_bank as jax_bank
from dl4ss_tpu.data.synth import sample_mixtures as jax_sample
from dl4ss_tpu.parallel import make_mesh as jax_make_mesh
from dl4ss_tpu.parallel import replicated as jax_replicated
from dl4ss_tpu.parallel import shard_batch as jax_shard_batch
from dl4ss_tpu.train import memory_trainer as jmt
from dl4ss_tpu.train import steps as jsteps
from dl4ss_tpu.train.state import create_train_state as jax_state
from dl4ss_tpu_torch import preset
from dl4ss_tpu_torch.parallel import (batch_sharding, make_mesh,
                                      param_sharding, shard_batch)
from dl4ss_tpu_torch.parallel import launch
from dl4ss_tpu_torch.parallel.launch import run_ranks
from dl4ss_tpu_torch.parallel.mesh import REPLICATED, ROWS, Mesh
from dl4ss_tpu_torch.parallel.multihost import (host_shard_list,
                                                host_shard_range)
from dl4ss_tpu_torch.run.train import build_parser, main
from dl4ss_tpu_torch.train.loop import train_loop
from dl4ss_tpu_torch.train.memory_trainer import memory_train_loop
from dl4ss_tpu_torch.train.state import create_train_state
from dl4ss_tpu_torch.utils import StepTimer, profile_trace, seed_everything
from dl4ss_tpu_torch.weights import flatten_tree
from torch_step_parity import assert_step_matches, jax_step, np_tree

# seconds: the bound on each spawned run of two ranks (~4-8 s here)
RANKS_TIMEOUT = 120
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_host_shard_math():
    assert host_shard_range(10, 0, 4) == (0, 3)
    assert host_shard_range(10, 1, 4) == (3, 6)
    assert host_shard_range(10, 2, 4) == (6, 8)
    assert host_shard_range(10, 3, 4) == (8, 10)
    items = list(range(10))
    got = [host_shard_list(items, p, 4) for p in range(4)]
    assert sum(got, []) == items
    # no process group: this process covers everything
    assert host_shard_list(items) == items


def test_mesh_shapes():
    mesh = make_mesh(dp=4, mp=2, devices=["cpu"] * 8)
    assert mesh.shape == {"data": 4, "model": 2}
    assert (mesh.data_index, mesh.model_index) == (0, 0)
    assert make_mesh(devices=["cpu"] * 8).shape["data"] == 8


def test_param_sharding_rules():
    cfg = preset("synth_tiny")
    model = create_train_state(cfg, device="cpu").model
    sh = param_sharding(make_mesh(dp=4, mp=2, devices=["cpu"] * 8), model)
    assert sh["embedding.table"] == ROWS
    assert sh["encoder.proj.w"] == REPLICATED
    assert set(sh.values()) == {ROWS, REPLICATED}
    # no model axis, or one that does not divide the rows: replicated
    for mp in (1, 3):
        sh = param_sharding(make_mesh(dp=1, mp=mp, devices=["cpu"] * 3),
                            model)
        assert set(sh.values()) == {REPLICATED}


def test_shard_batch_takes_this_ranks_rows():
    x = {"a": np.arange(16 * 5, dtype=np.float32).reshape(16, 5),
         "b": torch.arange(16), "none": None}
    mesh = make_mesh(dp=8, mp=1, devices=["cpu"] * 8)
    assert batch_sharding(mesh) == ("data",)
    out = shard_batch(x, mesh)
    np.testing.assert_array_equal(out["a"], x["a"][:2])
    assert out["none"] is None
    rank3 = Mesh(dp=4, mp=2, rank=7, device=torch.device("cpu"))
    assert rank3.data_index == 3 and rank3.model_index == 1
    assert torch.equal(shard_batch(x, rank3)["b"], torch.arange(12, 16))
    with pytest.raises(ValueError, match="split evenly"):
        shard_batch({"a": torch.zeros(3)}, mesh)


@pytest.mark.parametrize("loop", ["train", "memory"])
@pytest.mark.parametrize("dp,match", [
    (4, "batch_size"), (None, "exceeds the")])
def test_loops_validate_the_layout(loop, dp, match):
    """tests/test_sharding.py:156-171's counterparts, and the device count:
    JAX's messages, before any state is built."""
    dp = dp or (os.cpu_count() or 1) + 1
    cfg = preset("synth_tiny").replace(batch_size=3, dp_size=dp)
    with pytest.raises(ValueError, match=match):
        if loop == "train":
            train_loop(cfg, max_epochs=1, epoch_size=1, device="cpu")
        else:
            memory_train_loop(cfg, make_batch=lambda g: {}, max_epochs=1,
                              epoch_size=1, device="cpu")


def _with_ranks(rank_fn, args, jax_fn, world=2):
    """(jax_fn(), rank 0's result of rank_fn(*args) on `world` gloo ranks):
    the ranks run while JAX compiles and runs its step."""
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(run_ranks, rank_fn, world, args,
                            timeout=RANKS_TIMEOUT)
        ref = jax_fn()
        return ref, ranks.result()


def _jax_on_mesh(step_module, make_step, state_j, feats, dp=2):
    """A JAX step on a dp-way mesh of the CPU devices: the state
    replicated, the batch sharded over `data`."""
    mesh = jax_make_mesh(dp=dp, mp=1)
    state = jax.tree_util.tree_map(
        lambda x: jax.device_put(x, jax_replicated(mesh)), state_j)
    feats = jax_shard_batch({k: jnp.asarray(v) for k, v in feats.items()},
                            mesh)
    with jax.sharding.set_mesh(mesh):
        return jax_step(step_module, make_step, state, feats)


def _joint_step_against_jax_mesh(dp, rows):
    """One joint step (f32) on `dp` ranks, each on its `rows` rows of the
    batch, against JAX's on a dp-way mesh from the same parameters and
    batch: loss and grad norm 1e-5 relative; every gradient after the
    all-reduce and every update within torch_step_parity's gates."""
    cfg_j = jax_preset("synth_tiny").replace(batch_size=dp * rows)
    cfg_t = preset("synth_tiny").replace(batch_size=dp * rows)
    state_j = jax_state(jax.random.PRNGKey(0), cfg_j)
    bank = jnp.asarray(jax_bank(0, cfg_j.num_speakers, 2, cfg_j.max_len))
    feats = {k: np.array(v) for k, v in jax_featurize(
        jax_sample(jax.random.PRNGKey(1), bank, cfg_j), cfg_j).items()}
    before = dict(flatten_tree(np_tree(state_j.params)))
    ((new_j, met_j), grads_j), (new_t, met_t, grads_t) = _with_ranks(
        workers.joint_step, (cfg_t, np_tree(state_j.params), feats, dp),
        lambda: _jax_on_mesh(jsteps, lambda: jsteps.make_train_step(cfg_j),
                             state_j, feats, dp), world=dp)
    for key in ("loss", "mask_loss", "grad_norm"):
        assert abs(met_t[key] - float(met_j[key])) \
            <= 1e-5 * abs(float(met_j[key])), key
    assert_step_matches(before, new_j.params, new_t.model, grads_j, grads_t)


def test_dp2_joint_step_matches_jax_dp2_mesh():
    """Two ranks, each on its half of a B=4 batch, against JAX's dp=2 mesh
    (`_joint_step_against_jax_mesh`'s gates)."""
    _joint_step_against_jax_mesh(dp=2, rows=2)


def test_dp4_joint_step_matches_jax_dp4_mesh():
    """Four ranks at B=4 a rank (B=16), against JAX's dp=4 mesh of its CPU
    devices: the local batch at which four H100s over NCCL moved the
    joint step's gradients ~100x more than two ranks of eight rows did
    (PERF.md). Here, where both sides are f32, the port must match JAX at
    the dp=2 gates."""
    _joint_step_against_jax_mesh(dp=4, rows=4)


def test_dp2_memory_step_with_a_straddling_speaker_matches_jax():
    """One memory step (f32) on two ranks of a B=4 batch whose first and
    third items share their target speaker (one on each rank), against
    JAX's dp=2 mesh step: loss and grad norm 1e-5 relative, the gradients
    and updates within torch_step_parity's gates, the memory after the
    out-of-graph write within 1e-5 and its ages equal (the duplicate
    counted twice)."""
    small = dict(hidden_units=16, embedding_size=8, max_len_seconds=0.5,
                 num_speakers=6, batch_size=4, num_layers=1,
                 encoder_layers=1)
    cfg_j = jax_preset("cocktail_debug").replace(**small)
    cfg_t = preset("cocktail_debug").replace(**small)
    state_j = jmt.create_memory_state(jax.random.PRNGKey(0), cfg_j)
    bank = jnp.asarray(jax_bank(1, cfg_j.num_speakers, 2, cfg_j.max_len))
    b = jax_sample(jax.random.PRNGKey(1), bank, cfg_j)
    # the targets' labels: speaker 1 on rank 0 (item 0) and rank 1 (item 2)
    b = b._replace(spk_idx=b.spk_idx.at[:, 0].set(jnp.array([1, 3, 1, 4])))
    f = jax_featurize(b, cfg_j)
    mix_mag, target_mag = jax_target_mags(f, b, cfg_j)
    feats = {k: np.array(v) for k, v in {
        "mix_feas": f["mix_feas"], "mix_mag": mix_mag,
        "spk_id": b.spk_idx[:, 0], "clean_feas": f["src_feas"][:, 0],
        "target_mag": target_mag, "mix_ri": f["mix_ri"],
        "target_wav": b.source_wavs[:, 0]}.items()}
    spk = feats["spk_id"]
    before = dict(flatten_tree(np_tree(state_j.params)))
    memory = (np.asarray(state_j.memory.vectors),
              np.asarray(state_j.memory.age))
    ((new_j, met_j), grads_j), (new_t, met_t, grads_t) = _with_ranks(
        workers.memory_step, (cfg_t, np_tree(state_j.params), memory, feats),
        lambda: _jax_on_mesh(jmt, lambda: jmt.make_memory_train_step(cfg_j),
                             state_j, feats))
    for key in ("loss", "grad_norm"):
        assert abs(met_t[key] - float(met_j[key])) \
            <= 1e-5 * abs(float(met_j[key])), key
    assert_step_matches(before, new_j.params, new_t.model, grads_j, grads_t)
    np.testing.assert_allclose(new_t.memory.vectors.numpy(),
                               np.asarray(new_j.memory.vectors), atol=1e-5)
    np.testing.assert_array_equal(new_t.memory.age.numpy(),
                                  np.asarray(new_j.memory.age))
    assert int(new_t.memory.age[spk[0], 0]) == 2


def _cli_state(argv):
    state = main(argv)
    params = {k: v.detach().numpy() for k, v in
              state.model.state_dict().items()}
    return state, params


@pytest.fixture
def bounded_spawn(monkeypatch):
    """run.train's own spawn of its ranks, the join bounded by
    RANKS_TIMEOUT; yields the list of the spawns made."""
    spawns = []

    def bounded(fn, world, *args, **kwargs):
        spawns.append(world)
        return run_ranks(fn, world, *args, timeout=RANKS_TIMEOUT, **kwargs)

    monkeypatch.setattr(launch, "run_ranks", bounded)
    yield spawns


@pytest.mark.parametrize("mode", [
    ["--epochs", "1", "--seed", "3"],
    ["--mode", "adversarial", "--epochs", "1", "--seed", "7"],
    ["--mode", "adversarial", "--dis-sp", "--epochs", "1", "--seed", "9"],
    ["--mode", "memory", "--epochs", "2", "--seed", "5"],
    ["--mode", "image-query", "--epochs", "1", "--seed", "5"],
], ids=["joint", "adversarial", "dis_sp", "memory", "image_query"])
def test_cli_dp2_matches_single_device(mode, tmp_path, bounded_spawn):
    """`run.train --dp 2` (two gloo ranks) ends on the single-device run's
    parameters at 1e-5 (tests/test_sharding.py:67-154's bound): both
    optimizers in the adversarial modes, the memory rows too (ages
    equal). Rank 0 writes the checkpoint a single-device run writes, and
    it resumes under --dp 1."""
    common = ["--preset", "synth_tiny", "--device", "cpu", "--batch-size",
              "8", "--epoch-size", "2"] + mode
    ck = str(tmp_path / "ck")
    st_dp, p_dp = _cli_state(common + ["--dp", "2", "--checkpoint-dir", ck])
    assert bounded_spawn == [2]
    st_1, p_1 = _cli_state(common)
    assert set(p_dp) == set(p_1)
    for k in p_1:
        np.testing.assert_allclose(p_dp[k], p_1[k], atol=1e-5, err_msg=k)
    saved = torch.load(os.path.join(ck, f"step_{st_dp.step}.pt"),
                       weights_only=True)
    for k, v in saved["model"].items():
        np.testing.assert_array_equal(v.numpy(), p_dp[k], err_msg=k)
    if mode[0] != "--mode":
        resumed = main(common + ["--dp", "1", "--checkpoint-dir", ck,
                                 "--resume", "--epochs", "2"])
        assert resumed.step == 2 * st_dp.step
    if "adversarial" in mode:
        for a, b in zip(st_dp.d_opt_state.mu, st_1.d_opt_state.mu):
            np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)
    if "memory" in mode:
        np.testing.assert_allclose(st_dp.memory.vectors.numpy(),
                                   st_1.memory.vectors.numpy(), atol=1e-5)
        assert torch.equal(st_dp.memory.age, st_1.memory.age)


def test_cli_mp2_splits_the_table_and_keeps_the_grad_norm(tmp_path, capfd,
                                                         bounded_spawn):
    """`--dp 1 --mp 2`: the embedding table's rows live on their model
    rank (rank 0 holds rows 0:4 of 8) and the run ends on the
    single-device parameters at 1e-5, whole table included, with the same
    grad norm each epoch (the sharded rows counted once)."""
    common = ["--preset", "synth_tiny", "--device", "cpu", "--batch-size",
              "4", "--epochs", "2", "--epoch-size", "2", "--seed", "3"]
    st_mp, p_mp = _cli_state(common + ["--dp", "1", "--mp", "2",
                                       "--metrics", str(tmp_path / "mp")])
    assert bounded_spawn == [2]
    assert "embedding.table rows 0:4 of 8" in capfd.readouterr().out
    st_1, p_1 = _cli_state(common + ["--metrics", str(tmp_path / "one")])
    assert p_mp["embedding.table"].shape == (8, preset("synth_tiny")
                                             .query_dim)
    for k in p_1:
        np.testing.assert_allclose(p_mp[k], p_1[k], atol=1e-5, err_msg=k)
    for a, b in zip(st_mp.opt_state.nu, st_1.opt_state.nu):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-7)
    norms = [[json.loads(line)["grad_norm"] for line in
              open(tmp_path / name)] for name in ("mp", "one")]
    assert len(norms[0]) == 2
    np.testing.assert_allclose(norms[0], norms[1], rtol=1e-5)


def test_torchrun_ranks_join_the_launchers_group(tmp_path):
    """Under torchrun (WORLD_SIZE, RANK, MASTER_ADDR / MASTER_PORT set by
    the launcher) run.train joins the launcher's group instead of
    spawning: `--dp auto` takes the group's two ranks (JAX counts every
    process's devices, not one node's), and rank 0's checkpoint holds the
    single-device run's parameters at 1e-5."""
    common = ["--preset", "synth_tiny", "--device", "cpu", "--batch-size",
              "8", "--epoch-size", "2", "--epochs", "1", "--seed", "3"]
    ck = tmp_path / "ck"
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc-per-node", "2", "-m", "dl4ss_tpu_torch.run.train",
           *common, "--dp", "auto", "--checkpoint-dir", str(ck)]
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(
        [ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p])}
    proc = subprocess.Popen(cmd, cwd=ROOT, env=env, text=True,
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                            start_new_session=True)
    try:
        out, _ = proc.communicate(timeout=RANKS_TIMEOUT)
    finally:
        if proc.poll() is None:     # the launcher and its ranks, together
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, out[-4000:]
    assert "parallel: 2 ranks from the launcher over gloo" in out
    assert "mesh: data 2 x model 1 over gloo, rank 0 on cpu" in out
    st_1, p_1 = _cli_state(common)
    saved = torch.load(ck / f"step_{st_1.step}.pt", weights_only=True)
    assert set(saved["model"]) == set(p_1)
    for k, v in saved["model"].items():
        np.testing.assert_allclose(v.numpy(), p_1[k], atol=1e-5, err_msg=k)


@pytest.mark.parametrize("argv,message", [
    (["--dp", "2", "--batch-size", "3"],
     "dp_size=2 must divide batch_size=3 for even batch sharding"),
    (["--dp", str((os.cpu_count() or 1) + 1)],
     "exceeds the"),
])
def test_cli_refuses_a_layout_that_does_not_fit(argv, message):
    """The refusal comes before any rank starts, with JAX's message;
    `--dp 2` never runs as dp=1."""
    with pytest.raises(SystemExit, match=message):
        main(["--preset", "synth_tiny", "--device", "cpu"] + argv)


def test_cli_dp_and_mp_options_match_jax():
    """--dp: a string, default None ('auto' or an integer); --mp: an int,
    default None; 'auto' on the CPU is one rank."""
    from dl4ss_tpu_torch.run.train import _layout
    actions = {a.dest: a for a in build_parser()._actions}
    assert actions["dp"].default is None and actions["dp"].type is None
    assert actions["mp"].default is None and actions["mp"].type is int
    args = build_parser().parse_args(["--dp", "auto", "--device", "cpu"])
    cfg = _layout(preset("synth_tiny"), args)
    assert (cfg.dp_size, cfg.mp_size) == (1, 1)


def test_a_failing_rank_fails_the_run():
    """Rank 1 raises while rank 0 waits for it: the call raises, naming
    rank 1, well before the rendezvous timeout."""
    with pytest.raises(RuntimeError, match=r"ranks \[(0, )?1\] of 2 exited"):
        run_ranks(workers.fail_on_rank_1, 2, timeout=RANKS_TIMEOUT)


def test_seed_everything_repeats_draws():
    def draws(seed):
        gen = seed_everything(seed)
        return (np.random.rand(3), torch.rand(3), torch.rand(3,
                                                             generator=gen))
    a, b, c = draws(4), draws(4), draws(5)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    assert not np.array_equal(np.asarray(a[1]), np.asarray(c[1]))


def test_step_timer_and_profile_trace_on_the_cpu(tmp_path):
    """time_chain: each iteration takes the last one's output, the warm-up
    stays out of the clock, the result is ms per iteration (at least the
    10 ms each one sleeps); profile_trace writes a Chrome trace of the
    block."""
    seen = []

    def step(y):
        seen.append(int(y.sum()))
        time.sleep(0.01)
        return y + 1

    ms = StepTimer(warmup=2).time_chain(step, torch.zeros(3), iters=3)
    assert seen == [0, 3, 6, 9, 12]
    assert ms >= 10.0
    x = torch.randn(64, 64)
    with profile_trace(str(tmp_path)) as log_dir:
        torch.tanh(x @ x)
    trace = json.load(open(os.path.join(log_dir, "trace.json")))
    assert any("tanh" in e.get("name", "") for e in trace["traceEvents"])
