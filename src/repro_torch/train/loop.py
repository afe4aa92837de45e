"""Training loop of the port: gradient accumulation, checkpoint/restart,
fault injection. The counterpart of ``repro/train/loop.py``: the trainer
takes a mesh and places its state by :func:`make_train_rules` (FSDP over
"data", tensor-parallel over "model") through
:func:`~repro_torch.models.params.sharding_tree`, as the reference does.
With no mesh it trains on ``make_host_mesh(device)``, the card unless the
caller asks for the CPU.

On a mesh of more than one device the step runs SPMD, one process a
device, each with its process group up (the caller starts them; nothing
here finds a cluster): every rank holds its block of each parameter and
moment (a DTensor: "embed" over "data", heads, FFN and vocabulary over
"model"), takes its rows of each microbatch (the batch over "data") and
runs ``Model.loss(batch, ctx)`` with a
:class:`~repro_torch.models.layers.ShardCtx`: each weight is gathered over
"data" before use, activations are placed by the rules, and the backward
goes through the port's own collectives
(:mod:`repro_torch.dist.local`), so each rank's gradient comes back as its
block, summed over the ranks. AdamW then updates each rank's blocks in
place: elementwise, each element as on one device given the same
gradient. The dense, moe, ssm and hybrid families train on a mesh (moe
without a "pod" axis of more than one device, over which the rules would
shard its experts; mamba2's and zamba2's Mamba-2 blocks on each rank's
SSD heads); gemma2's alternation, whisper and internvl2 raise
``NotImplementedError`` at construction.

* every ``ckpt_every`` steps the full (params, opt, step) state is written
  atomically (:mod:`repro_torch.train.checkpoint`, the reference's format);
  on a mesh every leaf is gathered whole, rank 0 writes it and every rank
  waits for it at a barrier;
* a crash at any point restarts from the newest valid checkpoint, onto
  any mesh (each rank keeps its block of each leaf it reads); batches
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

import math
import time
from dataclasses import dataclass

import torch
from torch.profiler import record_function

from repro_torch.dist.local import is_dtensor, place_block
from repro_torch.dist.sharding import make_train_rules
from repro_torch.launch.mesh import make_host_mesh, mesh_device
from repro_torch.models import Model, ModelConfig, materialize
from repro_torch.models.layers import NULL_CTX, ShardCtx
from repro_torch.models.model import check_train_mesh
from repro_torch.models.params import flatten_tree, gather_tree, put_block, sharding_tree
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


def _local(t):
    """This rank's block of ``t`` (a plain tensor as it is)."""
    return t.to_local() if is_dtensor(t) else t


def _local_tree(tree: dict) -> dict:
    return {k: _local_tree(v) if isinstance(v, dict) else _local(v) for k, v in tree.items()}


class Trainer:
    """The accumulating train step on ``mesh``. Without a mesh,
    ``make_host_mesh(device)``: ``device`` None means the card, and a CUDA
    device with no card present raises (nothing here carries on silently
    on the CPU). On a mesh of more than one device this process steps its
    rank's device (its process group must be up) and ``device``, when
    given, must name it. ``mesh`` is a keyword here, where the reference
    takes it third, so that ``Trainer(cfg, tcfg, data, device=...)`` keeps
    working."""

    def __init__(self, cfg: ModelConfig, tcfg: TrainConfig, data: DataConfig | None = None,
                 device=None, *, mesh=None):
        self.cfg = cfg
        self.tcfg = tcfg
        self.mesh = make_host_mesh(device) if mesh is None else mesh
        if self.mesh.size > 1:
            check_train_mesh(cfg, self.mesh)
        self.device = mesh_device(self.mesh, device)
        self.rules = make_train_rules(self.mesh)
        self.ctx = ShardCtx(self.mesh, self.rules) if self.mesh.size > 1 else NULL_CTX
        self.param_tree = Model(cfg).describe()
        self.opt_tree = describe_opt_state(self.param_tree, bf16_moments=cfg.bf16_moments)
        self.data_cfg = data
        self.pipeline = TokenPipeline(data) if data else None
        self.metrics: list[dict] = []

    # ------------------------------------------------------------- state
    def adopt(self, params: dict, opt: dict | None = None, step: int = 0) -> TrainState:
        """A state over ``params`` (nested dict of tensors on the trainer's
        device, on a mesh this rank's blocks as DTensors placed by
        :meth:`shardings`, which the steps update in place): every floating
        leaf is set to require grad; ``opt`` defaults to zeroed moments."""
        for t in _leaves(params):
            if t.dtype.is_floating_point:
                t.requires_grad_(True)
        if opt is None:
            opt = self._zero_opt()
        return TrainState(params, opt, step)

    def _zero_opt(self) -> dict:
        """Zeroed optimizer state placed on the mesh; on a mesh of more
        than one device each rank's blocks are made as they are."""
        shardings = self.shardings()[1]
        if self.mesh.size == 1:
            return self._draw(self.opt_tree, shardings)

        def zeros(tree, shs):
            return {k: zeros(v, shs[k]) if isinstance(v, dict) else place_block(
                        torch.zeros(shs[k].shard_shape(v.shape), dtype=v.dtype,
                                    device=self.device),
                        self.mesh.device_mesh(), shs[k].placements(), v.shape)
                    for k, v in tree.items()}

        return zeros(self.opt_tree, shardings)

    def _draw(self, tree, shardings, seed: int = 0) -> dict:
        """``materialize(tree, seed)`` placed by ``shardings``: each leaf
        drawn by the reference's stream on the host and replaced at once by
        what the mesh holds of it (on a mesh this rank's block)."""
        by_name = dict(flatten_tree(shardings))
        return materialize(tree, seed=seed, keep=lambda name, t: put_block(t, by_name[name]))

    def init_state(self) -> TrainState:
        """Fresh parameters from ``tcfg.seed`` (the reference's stream,
        :func:`materialize`) and zeroed optimizer state, placed on the
        mesh leaf by leaf."""
        return self.adopt(self._draw(self.param_tree, self.shardings()[0], self.tcfg.seed))

    def shardings(self) -> tuple[dict, dict]:
        """The parameter and optimizer trees' shardings on the mesh."""
        return (sharding_tree(self.param_tree, self.mesh, self.rules),
                sharding_tree(self.opt_tree, self.mesh, self.rules))

    # -------------------------------------------------------------- step
    def gradients(self, state: TrainState, tokens, model: Model | None = None):
        """The mean gradient over the M microbatches of ``tokens`` (each
        leaf's in f32, on a mesh this rank's block, a plain tensor) and the
        microbatches' losses: what :meth:`train_step` hands AdamW."""
        model = model or Model(self.cfg, state.params)
        leaves = _leaves(state.params)
        with torch.no_grad():
            acc = [torch.zeros(_local(t).shape, dtype=torch.float32, device=self.device)
                   for t in leaves]
        losses = []
        for tok in tokens:
            with record_function("train.forward"):
                loss, _ = model.loss({"tokens": tok}, self.ctx)
            grads = torch.autograd.grad(loss, leaves)
            with record_function("train.accumulate"):
                for a, g, t in zip(acc, grads, leaves):
                    a += self._block(g, t)
            losses.append(loss.detach())
            # freed before the next microbatch's backward makes its own
            del grads, loss
        m = tokens.shape[0]
        with record_function("train.optimizer"):
            for a in acc:
                a /= m
        return acc, losses

    @staticmethod
    def _block(g, leaf):
        """The local block of the gradient ``g`` of ``leaf``: on a mesh in
        the leaf's own placements (:meth:`ShardCtx.param` brings it there)."""
        if not is_dtensor(leaf):
            return g
        if tuple(g.placements) != tuple(leaf.placements):
            raise RuntimeError(f"a gradient came back placed {g.placements}, its leaf "
                               f"{leaf.placements}")
        return g.to_local()

    def train_step(self, state: TrainState, tokens, model: Model | None = None):
        """One optimizer step on ``tokens`` [M, B/M, S+1] (on a mesh a
        DTensor sharded over "data" by rows, :meth:`_tokens_for`): M
        microbatches in sequence, grads summed in f32 and divided by M, then
        AdamW in place, on each rank's blocks. Returns the mean microbatch
        loss (a 0-d f32 tensor, the whole batch's on every rank)."""
        acc, losses = self.gradients(state, tokens, model)
        with record_function("train.optimizer"), torch.no_grad():
            grads = dict(zip((name for name, _ in flatten_tree(state.params)), acc))
            adamw_update(_nest(grads), _local_tree(state.opt), _local_tree(state.params),
                         lr=self.tcfg.lr)
        return torch.stack(losses).mean()

    def _tokens_for(self, step: int) -> torch.Tensor:
        """Step ``step``'s batch as ``[M, B/M, S+1]``; on a mesh this rank's
        rows of each microbatch (the reference's ``(None, "batch", None)``),
        as a DTensor placed so. A microbatch that the batch's axes do not
        divide raises, where the rules would replicate it."""
        batch = self.pipeline.batch_at(step)["tokens"]
        m = self.tcfg.microbatches
        b = batch.shape[0]
        if b % m:
            raise ValueError(f"global batch {b} is not a multiple of {m} microbatches")
        tokens = torch.from_numpy(batch.reshape(m, b // m, -1))
        if self.mesh.size == 1:
            return tokens.to(self.device)
        sizes = dict(self.mesh.shape)
        ranks = math.prod(sizes.get(a, 1) for a in self.rules.rules["batch"])
        if (b // m) % ranks:
            raise ValueError(f"a microbatch of {b // m} rows ({b} in {m} microbatches) is not "
                             f"divisible by the {ranks} ranks of the batch's axes "
                             f"{self.rules.rules['batch']}")
        sh = self.rules.sharding(self.mesh, (None, "batch", None), tuple(tokens.shape))
        local = tokens[sh.local_slices(tokens.shape, self.mesh.coordinates())]
        return place_block(local.to(self.device), self.mesh.device_mesh(), sh.placements(),
                           tokens.shape)

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
        """Write ``state``. On a mesh every rank gathers each leaf whole
        (:func:`gather_tree`), rank 0 writes them in the one-device format,
        and every rank waits at a barrier until it has."""
        tree = {"params": state.params, "opt": state.opt}
        if self.mesh.size == 1:
            self._write(tree, state.step)
            return
        import torch.distributed as dist

        tree = gather_tree(tree)
        if dist.get_rank() == 0:
            self._write(tree, state.step)
        dist.barrier()

    def _write(self, tree: dict, step: int) -> None:
        ckpt_lib.save(self.tcfg.ckpt_dir, step, tree,
                      extra={"model": self.cfg.name, "seed": self.tcfg.seed},
                      keep=self.tcfg.keep)

    def resume_or_init(self) -> TrainState:
        """Resume from the newest valid checkpoint onto the trainer's mesh
        (on a mesh each rank keeps its block of each whole leaf it reads,
        whatever mesh wrote it), else a fresh init."""
        if self.tcfg.ckpt_dir and ckpt_lib.latest_step(self.tcfg.ckpt_dir) is not None:
            p_sh, o_sh = self.shardings()
            by_key = {name.replace(".", "/"): sh
                      for name, sh in flatten_tree({"params": p_sh, "opt": o_sh})}
            tree, step, _ = ckpt_lib.restore(
                self.tcfg.ckpt_dir, {"params": self.param_tree, "opt": self.opt_tree},
                place=lambda key, t: put_block(t, by_key[key]))
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
