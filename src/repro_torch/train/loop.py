"""Training loop of the port: gradient accumulation, checkpoint/restart,
fault injection. The counterpart of ``repro/train/loop.py``: the trainer
takes a mesh and places its state by :func:`make_train_rules` (FSDP over
"data", tensor-parallel over "model") through
:func:`~repro_torch.models.params.sharding_tree`, as the reference does.
Its step runs on one device: a mesh of more than one device raises (the
step on sharded tensors is ROADMAP's next item). With no mesh it trains
on ``make_host_mesh(device)``, the card unless the caller asks for the
CPU.

* every ``ckpt_every`` steps the full (params, opt, step) state is written
  atomically (:mod:`repro_torch.train.checkpoint`, the reference's format);
* a crash at any point restarts from the newest valid checkpoint; batches
  come from a counter (:class:`~repro_torch.train.data.TokenPipeline`), so
  the resumed run consumes exactly the batches the crashed run would have;
  on the CPU the trajectory is bit-identical (the backward kernel on the
  card uses no atomics either);
* :class:`FaultInjector` raises at configurable steps to exercise that.

A step runs its M microbatches in sequence: each takes
``torch.autograd.grad`` of :meth:`Model.loss` over the parameter leaves,
the grads are summed into f32 accumulators and divided by M, as the
reference's ``lax.scan`` does, then :func:`adamw_update` updates the
leaves in place. ``record_function`` ranges name the forward, the
accumulation and the optimizer for a profiler (no cost without one).
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from repro_torch.dist.sharding import make_train_rules
from repro_torch.launch.mesh import make_host_mesh, one_device
from repro_torch.models import Model, ModelConfig, materialize
from repro_torch.models.params import device_put_tree, flatten_tree, sharding_tree
from repro_torch.train import checkpoint as ckpt_lib
from repro_torch.train.data import DataConfig, TokenPipeline
from repro_torch.train.optimizer import adamw_update, describe_opt_state


class InjectedFailure(RuntimeError):
    """A simulated node failure (a ``RuntimeError``, as the reference raises)."""


class FaultInjector:
    """Raises a simulated node failure at the given global steps."""

    def __init__(self, fail_at: tuple[int, ...] = ()):
        self.fail_at = set(fail_at)
        self.fired: set[int] = set()

    def check(self, step: int) -> None:
        if step in self.fail_at and step not in self.fired:
            self.fired.add(step)
            raise InjectedFailure(f"injected node failure at step {step}")


@dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # grad accumulation factor
    lr: float = 3e-4
    ckpt_every: int = 0            # 0 = no checkpointing
    ckpt_dir: str = ""
    keep: int = 3
    log_every: int = 10
    seed: int = 0


@dataclass
class TrainState:
    params: dict
    opt: dict
    step: int = 0


def _leaves(tree) -> list:
    return [t for _, t in flatten_tree(tree)]


class Trainer:
    """The accumulating train step on ``mesh``, which must be of one
    device. Without a mesh, ``make_host_mesh(device)``: ``device`` None
    means the card, and a CUDA device with no card present raises (nothing
    here carries on silently on the CPU). ``mesh`` is a keyword here, where
    the reference takes it third, so that ``Trainer(cfg, tcfg, data,
    device=...)`` keeps working."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data: DataConfig | None = None,
                 device=None, *, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = make_host_mesh(device) if mesh is None else mesh
        self.device = one_device(self.mesh, device)
        self.rules = make_train_rules(self.mesh)
        self.param_tree = Model(cfg).describe()
        self.opt_tree = describe_opt_state(self.param_tree, bf16_moments=cfg.bf16_moments)
        self.data_cfg = data
        self.pipeline = TokenPipeline(data) if data else None
        self.metrics: list[dict] = []

    # ------------------------------------------------------------- state
    def adopt(self, params: dict, opt: dict | None = None, step: int = 0) -> TrainState:
        """A state over ``params`` (nested dict of tensors on the trainer's
        device, which the steps update in place): every floating leaf is
        set to require grad; ``opt`` defaults to zeroed moments."""
        for t in _leaves(params):
            if t.dtype.is_floating_point:
                t.requires_grad_(True)
        if opt is None:
            opt = device_put_tree(materialize(self.opt_tree, device=self.device),
                                  self.shardings()[1])
        return TrainState(params, opt, step)

    def init_state(self) -> TrainState:
        """Fresh parameters from ``tcfg.seed`` (the reference's stream,
        :func:`materialize`) and zeroed optimizer state, placed on the
        mesh."""
        # drawn leaf by leaf onto the mesh's one device, where placing
        # them moves nothing
        params = materialize(self.param_tree, seed=self.tcfg.seed, device=self.device)
        return self.adopt(device_put_tree(params, self.shardings()[0]))

    def shardings(self) -> tuple[dict, dict]:
        """The parameter and optimizer trees' shardings on the mesh."""
        return (sharding_tree(self.param_tree, self.mesh, self.rules),
                sharding_tree(self.opt_tree, self.mesh, self.rules))

    # -------------------------------------------------------------- step
    def train_step(self, state: TrainState, tokens: torch.Tensor, model: Model | None = None):
        """One optimizer step on ``tokens`` [M, B/M, S+1]: M microbatches in
        sequence, grads summed in f32 and divided by M, then AdamW in place.
        Returns the mean microbatch loss (a 0-d f32 tensor)."""
        model = model or Model(self.cfg, state.params)
        leaves = _leaves(state.params)
        acc = [torch.zeros(t.shape, dtype=torch.float32, device=t.device) for t in leaves]
        losses = []
        for tok in tokens:
            with record_function("train.forward"):
                loss, _ = model.loss({"tokens": tok})
            grads = torch.autograd.grad(loss, leaves)
            with record_function("train.accumulate"):
                for a, g in zip(acc, grads):
                    a += g
            losses.append(loss.detach())
        m = tokens.shape[0]
        with record_function("train.optimizer"):
            for a in acc:
                a /= m
            grads = dict(zip((name for name, _ in flatten_tree(state.params)), acc))
            adamw_update(_nest(grads), state.opt, state.params, lr=self.tcfg.lr)
        return torch.stack(losses).mean()

    def _tokens_for(self, step: int) -> torch.Tensor:
        batch = self.pipeline.batch_at(step)["tokens"]
        m = self.tcfg.microbatches
        b = batch.shape[0]
        if b % m:
            raise ValueError(f"global batch {b} is not a multiple of {m} microbatches")
        return torch.from_numpy(batch.reshape(m, b // m, -1)).to(self.device)

    # -------------------------------------------------------------- run
    def run(self, state: TrainState | None = None,
            fault: FaultInjector | None = None) -> TrainState:
        """Run to ``tcfg.steps``; checkpoint periodically; propagate injected
        faults after making the state durable (the caller restarts through
        :meth:`resume_or_init`)."""
        tcfg = self.tcfg
        if state is None:
            state = self.resume_or_init()
        model = Model(self.cfg, state.params)
        t0 = time.time()
        while state.step < tcfg.steps:
            if fault is not None:
                fault.check(state.step)
            loss = self.train_step(state, self._tokens_for(state.step), model)
            state.step += 1
            if tcfg.log_every and state.step % tcfg.log_every == 0:
                self.metrics.append({"step": state.step, "loss": float(loss),
                                     "wall_s": round(time.time() - t0, 2)})
            if tcfg.ckpt_every and state.step % tcfg.ckpt_every == 0:
                self.save(state)
        if tcfg.ckpt_every:
            self.save(state)
        return state

    # ------------------------------------------------------ checkpointing
    def save(self, state: TrainState) -> None:
        ckpt_lib.save(
            self.tcfg.ckpt_dir, state.step, {"params": state.params, "opt": state.opt},
            extra={"model": self.cfg.name, "seed": self.tcfg.seed}, keep=self.tcfg.keep,
        )

    def resume_or_init(self) -> TrainState:
        """Resume from the newest valid checkpoint onto the trainer's
        device, else a fresh init."""
        if self.tcfg.ckpt_dir and ckpt_lib.latest_step(self.tcfg.ckpt_dir) is not None:
            tree, step, _ = ckpt_lib.restore(
                self.tcfg.ckpt_dir, {"params": self.param_tree, "opt": self.opt_tree},
                device=self.device)
            return self.adopt(tree["params"], tree["opt"], step)
        return self.init_state()


def _nest(flat: dict) -> dict:
    """A dotted-name dict as a nested one."""
    out: dict = {}
    for name, value in flat.items():
        *path, last = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[last] = value
    return out
