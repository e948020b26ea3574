"""The joint trainer data-parallel over `dp` cards, as `run.train --dp`
runs it: each unit is one step of `train.steps.make_fused_step` on a mesh
(`parallel.mesh.mesh_for_cfg`), every rank drawing the global batch from
the same generator and training on its rows of it, the gradients
averaged over the ranks by one all-reduce inside the step.

Rank 0 is the harness's own process on the run's card; ranks 1 to dp - 1
are processes of this file, one a further card (`cuda:<rank>`; on the CPU
gloo ranks), joined in one `torch.distributed` group (NCCL on cards).
They take rank 0's state and bank by broadcast in set-up and then step
in lock-step with it: before each of its steps rank 0 writes one byte to
each worker's standard input, and after the run's last step it writes
the byte that ends them. Nothing but the program's own collectives runs
in a step. A worker dies with the harness (the parent-death signal) and
ends when its standard input closes.

The traffic's `batch` is a rank's rows: `count` gives one rank's share of
a step, a unit holds `batch` x `dp` mixtures, and the
reference steps the global batch on the run's card, compared as
`harness/training.py` compares, the first gradient being the average the
optimizer gets.
"""

from __future__ import annotations

import ctypes
import datetime
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

REPO = Path(__file__).resolve().parents[2]
if __name__ == "__main__":
    sys.path.insert(0, str(REPO))

from benchmark.harness import flopcount as fc  # noqa: E402
from benchmark.harness import registry  # noqa: E402
from benchmark.harness.program import Ctx  # noqa: E402
from benchmark.harness.training import TrainDriver  # noqa: E402
from benchmark.reference import train as ref_train  # noqa: E402

STEP, STOP = b"s", b"q"
GROUP_TIMEOUT_S = 300    # a rank's wait for the others, then it fails
STOP_WAIT_S = 60


def count(layers, c: dict, b: int) -> fc.Count:
    """One rank's share of a step: the joint step of its `b` rows."""
    return registry.load_module("drivers", "train_joint").count(layers, c, b)


def _global(ctx: Ctx) -> Ctx:
    """The run's context as the program runs it: the configuration at the
    global batch and dp ranks; the traffic's batch the global one."""
    dp, rows = ctx.traffic["dp"], ctx.traffic["batch"]
    if ctx.config["config"]["batch_size"] != rows:
        raise ValueError("a rank's rows differ from the configuration's "
                         "batch")
    config = dict(ctx.config, config=dict(ctx.config["config"],
                                          batch_size=rows * dp, dp_size=dp))
    return ctx._replace(config=config,
                        traffic=dict(ctx.traffic, batch=rows * dp))


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def _rank_device(device: torch.device, rank: int) -> torch.device:
    return torch.device("cuda", rank) if device.type == "cuda" else device


class Driver(TrainDriver):
    loss_keys = ("loss",)
    late_keys = ("loss",)

    def __init__(self, ctx: Ctx):
        self.workers = []
        self.store_dir = None
        self.first_grads = None
        try:
            super().__init__(_global(ctx))
        except BaseException:
            self._stop_workers()
            raise
        # the first gradient as the optimizer got it: every rank's average
        self.record = self.record._replace(grads=self.first_grads)

    def make_step(self, cfg, steps_per_epoch):
        import torch.distributed as dist

        from dl4ss_tpu_torch.parallel.mesh import mesh_for_cfg, shard_state
        from dl4ss_tpu_torch.train.steps import make_fused_step
        dev = self.ctx.device
        self.store_dir = tempfile.mkdtemp(prefix="bench_dp_")
        store = os.path.join(self.store_dir, "store")
        spec = {"cell": self.ctx.cell, "seed": self.ctx.seed,
                "config": self.ctx.config, "traffic": self.ctx.traffic,
                "store": store, "world": cfg.dp_size, "parent": os.getpid()}
        for rank in range(1, cfg.dp_size):
            proc = subprocess.Popen(
                [sys.executable, __file__], stdin=subprocess.PIPE,
                stdout=subprocess.DEVNULL, cwd=str(REPO))
            proc.stdin.write((json.dumps(dict(
                spec, rank=rank, device=str(_rank_device(dev, rank))))
                + "\n").encode())
            proc.stdin.flush()
            self.workers.append(proc)
        dist.init_process_group(
            _backend(dev), init_method=f"file://{store}",
            world_size=cfg.dp_size, rank=0,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        mesh = mesh_for_cfg(cfg, dev)
        shard_state(self.state, mesh)
        dist.broadcast(self.bank, src=0)
        return make_fused_step(cfg, steps_per_epoch, mesh=mesh)

    def _signal(self, byte: bytes) -> None:
        for proc in self.workers:
            if proc.poll() is not None:
                raise RuntimeError(f"a rank exited with code "
                                   f"{proc.returncode}")
            proc.stdin.write(byte)
            proc.stdin.flush()

    def step_once(self):
        self._signal(STEP)
        if self.first_grads is not None:
            self.state, metrics = self.step(self.state, self.bank)
            return metrics
        from dl4ss_tpu_torch.train import state as st
        names = {id(p): n for n, p in self.state.model.named_parameters()}
        real = st.Optimizer.update

        def update(opt, params, grads, *args, **kwargs):
            self.first_grads = {names[id(p)]: g.detach().clone()
                                for p, g in zip(params, grads)}
            return real(opt, params, grads, *args, **kwargs)

        st.Optimizer.update = update
        try:
            self.state, metrics = self.step(self.state, self.bank)
        finally:
            st.Optimizer.update = real
        return metrics

    def _stop_workers(self) -> None:
        """End the workers: the stop byte and closed pipes, this rank's
        group ended while they end theirs (NCCL may wait for every rank
        there), then a wait for them, killed if they have not ended in
        time."""
        import torch.distributed as dist
        for proc in self.workers:
            try:
                if proc.poll() is None:
                    proc.stdin.write(STOP)
                proc.stdin.close()
            except OSError:
                pass
        if dist.is_initialized():
            dist.destroy_process_group()
        for proc in self.workers:
            try:
                proc.wait(STOP_WAIT_S)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        self.workers = []
        if self.store_dir:
            shutil.rmtree(self.store_dir, ignore_errors=True)
            self.store_dir = None

    def free_program(self) -> None:
        self.sync()
        self._stop_workers()
        super().free_program()

    def ref_optimizers(self, params, c):
        return [ref_train.Adam(params, ref_train.generator_names(params), c)]

    def ref_step(self, params, opts, batch, c):
        loss, grads = ref_train.joint_step(params, opts[0], batch, c)
        return (loss,), grads

    def ref_late(self, params, batch, c):
        return ref_train.joint_late(params, batch, c)


def _die_with_parent(parent: int) -> None:
    """SIGKILL this process when its parent dies (Linux's parent-death
    signal), and exit now if it already has."""
    try:
        ctypes.CDLL(None, use_errno=True).prctl(1, signal.SIGKILL)
    except (AttributeError, OSError):
        pass
    if os.getppid() != parent:
        os._exit(1)


def worker() -> int:
    """Rank `rank` of the run the first line of standard input describes:
    the state and bank come from rank 0; one step a STEP byte."""
    import torch.distributed as dist

    from dl4ss_tpu_torch.models.separator import init_separator
    from dl4ss_tpu_torch.parallel.mesh import mesh_for_cfg, shard_state
    from dl4ss_tpu_torch.train.state import create_train_state
    from dl4ss_tpu_torch.train.steps import make_fused_step
    from benchmark.harness.program import port_config
    spec = json.loads(sys.stdin.buffer.readline())
    _die_with_parent(spec["parent"])
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS"):
        os.environ.setdefault(var, "1")
    torch.set_num_threads(1)
    dev = torch.device(spec["device"])
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    cfg = port_config(spec["config"])
    state = create_train_state(cfg, 0, cfg.epoch_size, dev,
                               model=init_separator(cfg, device=dev))
    utts = spec["traffic"]["bank"]["utterances"]
    bank = torch.empty((cfg.num_speakers, utts, cfg.max_len), device=dev)
    dist.init_process_group(
        _backend(dev), init_method=f"file://{spec['store']}",
        world_size=spec["world"], rank=spec["rank"],
        timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    try:
        mesh = mesh_for_cfg(cfg, dev)
        shard_state(state, mesh)
        dist.broadcast(bank, src=0)
        step = make_fused_step(cfg, cfg.epoch_size, mesh=mesh)
        while sys.stdin.buffer.read(1) == STEP:
            state, _ = step(state, bank)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker())
