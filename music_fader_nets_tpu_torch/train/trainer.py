"""The trainer of every family (counterpart of
`music_fader_nets_tpu/train/trainer.py`).

A step: the loss on the fast parameter layout (`models/fast.py`), its
backward, the global-norm clip at 1.0 (two kernels on a GPU,
`ops/cuda_clip.py`; `clip_path` says which path served) and Adam(lr)
(reference trainer.py:49,157; `make_optimizer`). Adam steps the
fast-layout leaves; the parity-only layers (`fast.FROZEN_KEYS`) and the
frozen mixture logvar tables take no update, as in the JAX package, where
their gradients are zero. `state` / `load_state` carry a `TrainState` of
canonical trees (params, the optax-shaped Adam state, the step) out and
in: what a checkpoint holds.

The objective's random draws are the caller's: `noise_fn(host_step, B,
loss_fn)`, by default `objectives.draw_noise` (what that objective draws,
see `train/objectives.py`) from a `torch.Generator` seeded from (seed,
host_step). The host step counts every batch, training and evaluation, as
the JAX Trainer's `_host_step` does, so a test can hand both trainers the
same draws. `run_epoch(compiled=True)` follows the noise schedule of the
JAX Trainer's compiled epoch instead (trainer.py:148, :261): every batch
draws `noise_fn(h, B, loss_fn, step=s)` with h the host step at the
epoch's start and s the training step, and the epoch then advances the
host step by its batch count, so an evaluation epoch reuses one draw for
every batch. `fit` and the training CLI run that schedule, as the JAX
package's do. The computation is the streaming step either way.

A mesh (`mesh=`, a `parallel.mesh.Mesh` of n_data x n_model ranks, one
process each) is the counterpart of the JAX Trainer's mesh path.

Data parallelism (the `data` axis): each rank feeds the rows of its data
index, `batch_size // n_data` of each global batch (its corpus shard from
`data.loader.shard_arrays_for_process` at its data index); the noise is
drawn for the global batch and sliced to the rank's rows, so the ranks see
the noise of one process at the global batch. The params are broadcast
from rank 0 at `__init__` and `load_state`. The loss runs under
`parallel.mesh.trace_mesh_scope`, where the terms that couple rows (Pati,
GLSR's batch-0 read) gather the global batch over the data group
(`losses/regularizers.py`). After `loss.backward()` ONE flat all-reduce
(mean) over the data group of every trainable gradient, with the step's
metrics in the same buffer, runs before the clip: the clip's norm is the
global batch's, the data ranks' Adam states stay equal, and the metrics
are the global batch's. That all-reduce stands in
for the `psum` over `data` of the weight gradients in the JAX package's
six `_dp` shard_map wrappers (`ops/pallas_gru.py`: `stacked_gru_pallas_dp`,
`stacked_gru_embed_finals_dp`, `stacked_gru_embed_seq_dp`,
`_dec_teacher_core_dp`, `_dec_nll_core_dp`, `_dec_mask_core_dp`) together
with GSPMD's `psum` of every other leaf: the kernels run on a rank's rows
as those wrappers run them on a device's, and no wrapper reduces on its
own.

Tensor parallelism (the `model` axis, n_model > 1): the leaves that
`parallel.mesh.fast_pspecs` shards (the GRU weights and biases, along 3H)
are stored, and stepped by Adam, as this rank's slice only, so Adam's
`mu` / `nu` of those leaves take 1 / n_model of their bytes on each rank.
A step is: (1) the model group gathers the slices into the whole leaves
that the forward and the kernels read (`collectives.all_gather_model_`,
one all-reduce of a zeroed buffer: exact), (2) forward and backward,
unchanged, (3) the all-reduce over the data group above, (4) the clip on
the whole gradients, so its norm is the one a single process computes,
(5) each sharded gradient's slice taken and Adam stepped on the slices and
on the whole replicated leaves. The ranks of a model group feed the same
rows and so compute the same gradients; the gather also hands every rank
model index 0's replicated leaves, so a CUDA op that rounds two runs apart
cannot part the ranks' weights. Nothing is summed in another order than
in one process, so a 1 x m mesh takes the steps of one process bit for
bit, and a d x m mesh those of the d x 1 mesh. `params` and `state`
gather the slices (Adam's moments too): under a model axis every rank
must call them. `load_state` slices; a checkpoint's layout does not
depend on the mesh.

`fit` logs and checkpoints on rank 0 only, the other ranks waiting at a
barrier; the step timers synchronise and meet at a barrier around each
window.

With the program's spans on (`utils/profiling.py`), a step records
`train.step` around `train_step` and, under it, `train.forward` (the
objective's call), `train.backward` (`loss.backward()` and the zero
gradients' fill), `train.allreduce` (with a mesh), `train.clip` and
`train.adam`, each linked by the training step and with the thread's CPU
time at both ends.
"""
from __future__ import annotations

import time
from typing import Callable, Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.distributed as dist

from music_fader_nets_tpu_torch import resolve_device
from music_fader_nets_tpu_torch.config import ModelConfig
from music_fader_nets_tpu_torch.data.loader import batch_iterator
from music_fader_nets_tpu_torch.models import fast as fast_lib
from music_fader_nets_tpu_torch.ops import (
    cuda_clip, cuda_decoder, cuda_gru, cuda_stacked,
)
from music_fader_nets_tpu_torch.parallel.collectives import (
    all_gather_model_, all_reduce_mean_,
)
from music_fader_nets_tpu_torch.parallel.mesh import (
    fast_pspecs, model_shard, model_slice, shard_params, trace_mesh_scope,
)
from music_fader_nets_tpu_torch.train.objectives import draw_noise
from music_fader_nets_tpu_torch.utils.checkpoint import (
    check_params_like, tree_map, tree_to,
)
from music_fader_nets_tpu_torch.utils.profiling import SPANS

# the kernel wrappers' modules whose LAST_TRAIN_PATH a step reads
_PATH_MODULES = (cuda_gru, cuda_decoder, cuda_stacked)

# leaves of the fast tree that Adam does not step (no gradient reaches
# them: reference gmm_model.py:151-184 keeps them fixed)
FROZEN_TABLES = ("logvar_r_lookup", "logvar_n_lookup")
# torch.optim.Adam's moments (optax's mu and nu)
_MOMENTS = ("exp_avg", "exp_avg_sq")
_STEP, _FORWARD, _BACKWARD, _ALLREDUCE, _CLIP, _ADAM = (
    SPANS.name(f"train.{n}") for n in (
        "step", "forward", "backward", "allreduce", "clip", "adam"))


class TrainState(NamedTuple):
    """What a checkpoint holds: the canonical params tree, the canonical
    Adam state {"count", "mu", "nu"} (`models/fast.py::
    opt_state_merge_canonical`; None = a fresh optimizer) and the training
    step, which drives the KL anneal."""
    params: Dict
    opt_state: Optional[Dict]
    step: int


def _leaves(tree, prefix=()):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (k,))
    else:
        yield prefix, tree


def trainable_leaves(fast):
    """[(path, tensor)] of the leaves of a fast-layout tree that Adam
    steps, in the Trainer's order (the order of its clip's table too)."""
    return [(path, t) for path, t in _leaves(fast)
            if path[0] not in FROZEN_TABLES]


class Optimizer(NamedTuple):
    """The `Trainer`'s update, what `make_optimizer` returns: `clip_` the
    gradients by their global norm at `max_norm` (optax's rule; the two
    kernels of `ops/cuda_clip.py` for CUDA gradients), then step
    a `torch.optim.Adam` from `adam` at `lr` (optax's defaults: betas
    (0.9, 0.999), eps 1e-8). The two are apart because under a model axis
    the clip reads the whole gradients and Adam steps their slices."""
    lr: float
    max_norm: float = 1.0

    def adam(self, tensors) -> torch.optim.Adam:
        return torch.optim.Adam(tensors, lr=self.lr)

    def clip_(self, grads) -> torch.Tensor:
        return cuda_clip.clip_global_norm_(grads, self.max_norm)


def make_optimizer(cfg: ModelConfig) -> Optimizer:
    """clip_by_global_norm(1.0) then Adam(cfg.lr) (JAX :33-37: optax.chain
    of the two), matching the reference's `clip_grad_norm_(1)` +
    `optim.Adam(lr)` (trainer.py:49,157)."""
    return Optimizer(cfg.lr, 1.0)


class Trainer:
    def __init__(self, cfg: ModelConfig, init_fn: Callable,
                 loss_fns: Dict[str, Callable], seed: int = 0, params=None,
                 device=None, noise_fn: Optional[Callable] = None,
                 mesh=None):
        """loss_fns: named objectives, e.g. {"default": vanilla_loss}, or
        {"default": gmm_loss, "supervised": partial(gmm_loss,
        is_supervised=True)} for the dual-corpus GM-VAE loop. `params` is
        a canonical tree (default: `init_fn(torch.Generator().manual_seed(
        seed), cfg)`); it is copied. `mesh`: a data x model mesh
        (`parallel.make_mesh`; module docstring), whose device is the
        default one; ValueError when its model axis does not divide 3H.
        Runs on CUDA unless device="cpu" (RuntimeError without a card)."""
        self.cfg = cfg
        self.mesh = mesh
        if mesh is not None and device is None:
            device = mesh.device
        self.device = resolve_device(device)
        self.seed = seed
        self._opt = make_optimizer(cfg)
        if params is None:
            params = init_fn(torch.Generator().manual_seed(seed), cfg)
        self._set_params(params)
        self._loss_fns = dict(loss_fns)
        self.noise_fn = noise_fn or self._default_noise
        self.step = 0            # training steps taken; drives KL annealing
        self._host_step = 0      # batches seen; drives the noise
        self.epoch = 0           # epochs completed (fit, the training CLI)
        self.train_path = None   # "kernel" / "plain-cpu" of the last step
        self.clip_path = None    # the same of its clip

    @property
    def _model_axis(self) -> bool:
        return self.mesh is not None and self.mesh.n_model > 1

    def _set_params(self, params) -> None:
        """Own copies of the canonical `params` in the fast layout, and a
        fresh Adam over the leaves it steps: the trainable leaves, or
        under a model axis this rank's slices of the sharded ones."""
        params = tree_to(params, self.device)
        # merge_canonical reads only the canonical shapes
        self._template = tree_map(lambda t: t.to("meta"), params)
        fast, frozen = fast_lib.split_fast(params)
        own = (lambda t: t.detach().clone())
        self._fast = tree_map(own, fast)
        self._frozen = tree_map(own, frozen)
        if self.mesh is not None:
            shard_params({"fast": self._fast, "frozen": self._frozen},
                         self.mesh)
        trainable = trainable_leaves(self._fast)
        self._trainable_paths = [path for path, _ in trainable]
        self._trainable = [t for _, t in trainable]
        for t in self._trainable:
            t.requires_grad_(True)
        # the tensors Adam steps, one a trainable leaf: the leaf itself, or
        # under a model axis this rank's slice of a sharded one
        self._stepped = self._trainable
        if self._model_axis:
            specs = fast_pspecs(self._fast)
            local = dict(_leaves(model_shard(
                self._fast, specs, self.mesh.n_model, self.mesh.model_index)))
            specs = dict(_leaves(specs))
            self._specs = [specs[path] for path in self._trainable_paths]
            self._stepped = [
                local[path].detach().clone(
                    memory_format=torch.contiguous_format) if spec else t
                for path, t, spec in zip(self._trainable_paths,
                                         self._trainable, self._specs)]
        self.optimizer = self._opt.adam(self._stepped)
        self._stale = False     # whole leaves behind their slices

    def _local(self, t: torch.Tensor, spec: tuple) -> torch.Tensor:
        """This rank's slice of `t` along the axis `spec` puts over
        `model` (a view)."""
        return model_slice(t, spec, self.mesh.n_model, self.mesh.model_index)

    def _gather(self) -> None:
        """Under a model axis, after an Adam step: the whole trainable
        leaves rebuilt from the model group's slices, and the replicated
        ones made model index 0's (one all-reduce; a collective, called at
        the same points on every rank). Nothing when they are current."""
        if not self._stale:
            return
        first = self.mesh.model_index == 0
        shards = [s if spec or first else None
                  for s, spec in zip(self._stepped, self._specs)]
        all_gather_model_(self._trainable, shards, self._specs, self.mesh)
        self._stale = False

    def _full_optimizer(self) -> torch.optim.Adam:
        """An Adam whose state is keyed by the whole trainable leaves: the
        optimizer itself, or under a model axis a stand-in holding each
        sharded leaf's moments gathered over the model group (a
        collective) and this rank's moments of the replicated ones."""
        if not self._model_axis:
            return self.optimizer
        full = self._opt.adam(self._trainable)
        state = self.optimizer.state
        rows = [(t, s, spec) for t, s, spec in zip(
            self._trainable, self._stepped, self._specs) if s in state]
        for t, s, spec in rows:
            full.state[t] = {"step": state[s]["step"], **{
                k: torch.zeros_like(t) if spec else state[s][k]
                for k in _MOMENTS}}
        sharded = [(t, s, spec) for t, s, spec in rows if spec]
        all_gather_model_(
            [full.state[t][k] for k in _MOMENTS for t, _, _ in sharded],
            [state[s][k] for k in _MOMENTS for _, s, _ in sharded],
            [spec for _ in _MOMENTS for _, _, spec in sharded], self.mesh)
        return full

    def _default_noise(self, host_step: int, B: int, loss_fn: Callable,
                       step: Optional[int] = None):
        if step is None:
            key = self.seed * 1_000_003 + host_step
        else:
            key = int(np.random.SeedSequence(
                [self.seed, host_step, step]).generate_state(1, np.uint64)[0])
        gen = torch.Generator().manual_seed(key)
        return draw_noise(loss_fn, gen, B, self.cfg)

    @property
    def fast_params(self) -> Dict:
        """The fast-layout tree that the forward reads (live tensors).
        Under a model axis its sharded leaves lag Adam's slices between a
        step and the next gather (the next step, `params`, `state`)."""
        return self._fast

    @property
    def params(self) -> Dict:
        """The canonical tree (copies), `merge_canonical` of the fast one.
        Under a model axis it first gathers the slices: every rank calls
        it."""
        self._gather()
        fast = tree_map(lambda t: t.detach().clone(), self._fast)
        frozen = tree_map(lambda t: t.clone(), self._frozen)
        return fast_lib.merge_canonical(fast, frozen, self._template)

    @property
    def state(self) -> TrainState:
        """The training state as canonical trees (copies, on the trainer's
        device). Under a model axis it gathers the params and Adam's
        moments over the model group: every rank calls it."""
        return TrainState(self.params, fast_lib.opt_state_merge_canonical(
            self._full_optimizer(), self._fast, self._template), self.step)

    def load_state(self, state: TrainState,
                   host_step: Optional[int] = None) -> None:
        """Continue from `state` (a `TrainState` of canonical trees, e.g. a
        restored checkpoint; opt_state None = a fresh optimizer). The noise
        stream resumes at `host_step`, by default at the state's step, as
        the JAX training CLI resumes (train/cli.py:205). Under a model
        axis each rank keeps its slices of the params and of Adam's
        moments. Raises ValueError if the params are not this model's."""
        check_params_like(state.params, self._template)
        self._set_params(state.params)
        if state.opt_state is not None:
            full = (self._opt.adam(self._trainable) if self._model_axis
                    else self.optimizer)
            fast_lib.opt_state_split_fast(state.opt_state, full, self._fast)
            if self._model_axis:
                for t, s, spec in zip(self._trainable, self._stepped,
                                      self._specs):
                    if t in full.state:
                        self.optimizer.state[s] = {
                            k: v if k == "step" or not spec else
                            self._local(v, spec).clone(
                                memory_format=torch.contiguous_format)
                            for k, v in full.state[t].items()}
        self.step = int(state.step)
        self._host_step = self.step if host_step is None else int(host_step)

    @property
    def is_lead(self) -> bool:
        """True on the rank that logs and checkpoints (rank 0; the only
        process without a mesh)."""
        return self.mesh is None or self.mesh.rank == 0

    def barrier(self) -> None:
        """Wait for every rank of the mesh (nothing without one)."""
        if self.mesh is not None:
            dist.barrier()

    def _sync(self) -> None:
        """Wait for the device, then for every rank."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.barrier()

    def _local_batch_size(self, bs: int) -> int:
        """The rows this rank feeds of a global batch of `bs` (JAX
        :178-189): bs // n over n data ranks. Raises ValueError when n
        does not divide bs."""
        n = 1 if self.mesh is None else self.mesh.n_data
        if bs % n:
            raise ValueError(f"global batch {bs} not divisible over {n} "
                             f"data ranks")
        return bs // n

    def _rank_noise(self, noise, bs: int):
        """This rank's rows of the global batch's draws (every draw leads
        with the batch axis), by its data index, on the device."""
        lo = 0 if self.mesh is None else self.mesh.data_index * bs
        return tuple(e[lo: lo + bs].to(self.device, torch.float32)
                     for e in noise)

    def _batch(self, batch: Dict[str, np.ndarray]):
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in batch.items()}

    def compute_gradients(self, loss_fn: Callable, batch, eps):
        """The loss and its backward on a batch of device tensors (this
        rank's rows, and `eps` its rows of the draws), leaving each
        trainable leaf's `.grad` set (the whole leaf's, under a model axis
        too, after the gather of its slices); with a mesh, then the one
        all-reduce (mean) of the gradients and the metrics over the data
        group. Returns the metrics, the global batch's."""
        for m in _PATH_MODULES:
            m.LAST_TRAIN_PATH = None
        self._gather()
        with SPANS.span(_FORWARD, self.step, cpu=True), \
                trace_mesh_scope(self.mesh):
            loss, metrics = loss_fn(self._fast, eps, batch, self.step,
                                    self.cfg)
        with SPANS.span(_BACKWARD, self.step, cpu=True):
            for t in self._trainable:
                t.grad = None
            loss.backward()
            paths = {m.LAST_TRAIN_PATH for m in _PATH_MODULES} - {None}
            self.train_path = paths.pop() if len(paths) == 1 else "mixed"
            grads = []
            for t in self._trainable:
                if t.grad is None:      # optax steps a zero gradient too
                    t.grad = torch.zeros_like(t)
                grads.append(t.grad)
        if self.mesh is None:
            return metrics
        with SPANS.span(_ALLREDUCE, self.step, cpu=True):
            names = sorted(metrics)
            vals = torch.stack([metrics[k].detach().to(grads[0].dtype)
                                for k in names])
            all_reduce_mean_(grads + [vals], self.mesh)
        return dict(zip(names, vals.unbind()))

    def train_step(self, loss_fn: Callable, batch, eps):
        """One step on a batch of device tensors (`compute_gradients`, the
        global-norm clip on the whole gradients, Adam on what it steps);
        returns the metrics."""
        with SPANS.span(_STEP, self.step, cpu=True):
            metrics = self.compute_gradients(loss_fn, batch, eps)
            with torch.no_grad(), SPANS.span(_CLIP, self.step, cpu=True):
                self._opt.clip_([t.grad for t in self._trainable])
                self.clip_path = cuda_clip.LAST_CLIP_PATH
                if self._model_axis:
                    for t, s, spec in zip(self._trainable, self._stepped,
                                          self._specs):
                        if spec:
                            s.grad = self._local(t.grad, spec).clone(
                                memory_format=torch.contiguous_format)
            with SPANS.span(_ADAM, self.step, cpu=True):
                self.optimizer.step()
            self._stale = self._model_axis
            self.step += 1
        return metrics

    def run_epoch(self, arrays: Dict[str, np.ndarray],
                  variant: str = "default", train: bool = True,
                  shuffle: bool = True, seed: Optional[int] = None,
                  batch_size: Optional[int] = None,
                  compiled: bool = False) -> Dict[str, float]:
        """One pass over `arrays` in batches (the last partial one
        dropped); returns the per-batch mean of each metric. Evaluation
        (train=False) runs the same objective without a gradient, as the
        JAX Trainer's eval step does. compiled=True draws the noise as the
        JAX Trainer's compiled epoch does (module docstring). With a mesh,
        `arrays` is this rank's shard, `batch_size` the global batch, and
        the metrics are the global batch's."""
        n = len(next(iter(arrays.values())))
        if n == 0:
            return {}
        # with a mesh, `arrays` holds this rank's shard: the global item
        # count is n * ranks (JAX :246-251)
        ranks = 1 if self.mesh is None else self.mesh.n_data
        bs = min(batch_size or self.cfg.batch_size, n * ranks)
        bs_local = self._local_batch_size(bs)
        loss_fn = self._loss_fns[variant]
        start = self._host_step
        totals, nb = None, 0
        for host_batch in batch_iterator(arrays, bs_local, shuffle=shuffle,
                                         seed=seed):
            if compiled:
                noise = self.noise_fn(start, bs, loss_fn, step=self.step)
            else:
                noise = self.noise_fn(self._host_step, bs, loss_fn)
                self._host_step += 1
            eps = self._rank_noise(noise, bs_local)
            batch = self._batch(host_batch)
            if train:
                metrics = self.train_step(loss_fn, batch, eps)
            else:
                self._gather()
                with torch.no_grad(), trace_mesh_scope(self.mesh):
                    _, metrics = loss_fn(self._fast, eps, batch, self.step,
                                         self.cfg)
            vals = torch.stack([metrics[k].detach() for k in sorted(metrics)])
            totals = vals if totals is None else totals + vals
            nb += 1
        if compiled:
            self._host_step = start + nb
        if totals is None:
            return {}
        if self.mesh is not None and not train:
            all_reduce_mean_([totals], self.mesh)
        return {k: v / nb for k, v in zip(sorted(metrics), totals.tolist())}

    def fit(self, train_arrays, val_arrays=None,
            n_epochs: Optional[int] = None,
            log_fn: Callable[[str], None] = print,
            checkpoint_fn: Optional[Callable[[TrainState, int], None]] = None,
            metrics_logger=None, start_epoch: int = 1) -> TrainState:
        """Epochs `start_epoch`..`n_epochs` (default cfg.n_epochs), each a
        training pass (shuffled with seed = epoch) and, with `val_arrays`,
        an evaluation pass, on the compiled epoch's noise schedule; the JAX
        Trainer's log lines, `metrics_logger.log` records and
        `checkpoint_fn(state, epoch)` after each epoch; with a mesh, on
        rank 0 only, the other ranks waiting at a barrier. Returns the
        state."""
        n_epochs = n_epochs or self.cfg.n_epochs
        if not self.is_lead:
            log_fn, metrics_logger = (lambda _: None), None
        for epoch in range(start_epoch, n_epochs + 1):
            log_fn(f"Epoch {epoch} / {n_epochs}")
            t0 = time.time()
            tr = self.run_epoch(train_arrays, train=True, seed=epoch,
                                compiled=True)
            lines = [f"train loss: {tr.get('loss', float('nan')):.4f}"
                     f"  ({time.time() - t0:.1f}s)"]
            ev = None
            if val_arrays is not None:
                ev = self.run_epoch(val_arrays, train=False, shuffle=False,
                                    compiled=True)
                lines.append(f"val loss: {ev.get('loss', float('nan')):.4f}")
            log_fn("  ".join(lines))
            log_fn("train by term - " + " ".join(
                f"{k}: {v:.4f}" for k, v in sorted(tr.items()) if k != "loss"))
            if metrics_logger is not None:
                metrics_logger.log(tr, step=self._host_step, epoch=epoch,
                                   split="train")
                if ev is not None:
                    metrics_logger.log(ev, step=self._host_step, epoch=epoch,
                                       split="val")
            self.epoch = epoch
            if checkpoint_fn is not None:
                self.checkpoint(checkpoint_fn, epoch)
        return self.state

    def checkpoint(self, checkpoint_fn: Callable[[TrainState, int], None],
                   epoch: int) -> None:
        """`checkpoint_fn(state, epoch)` on rank 0 (the only process without
        a mesh), the other ranks waiting at a barrier until it is done.
        Every rank takes the state (a collective under a model axis)."""
        state = self.state
        if self.is_lead:
            checkpoint_fn(state, epoch)
        self.barrier()

    def _timing_batches(self, arrays, bs: int, n: int):
        """`n` batches of this rank's rows of a global batch of `bs` (the
        corpus repeated as needed), on the device."""
        bs = self._local_batch_size(bs)
        rows = len(next(iter(arrays.values())))
        reps = -(-n * bs // rows)
        tiled = {k: np.concatenate([v] * reps)[: n * bs]
                 for k, v in arrays.items()}
        return [self._batch(b) for b in
                batch_iterator(tiled, bs, shuffle=False)]

    def compiled_step_time(self, arrays, variant: str = "default",
                           iters: int = 20,
                           batch_size: Optional[int] = None,
                           spread: bool = False):
        """Seconds per training step: `iters` steps, three timed windows
        after one warm-up window, each ended by a device synchronise;
        returns the best window, or (best, [window seconds]) with
        spread=True. The steps run on a copy of the trainer, so the live
        state is never touched. Counterpart of the JAX Trainer's timer of
        its compiled whole-epoch program; until the port has a CUDA graph
        of the step, this times the streaming step. With a mesh every rank
        calls it; `batch_size` is the global batch."""
        bs = batch_size or self.cfg.batch_size
        loss_fn = self._loss_fns[variant]
        state = self.state
        twin = Trainer(self.cfg, None, self._loss_fns, seed=self.seed,
                       params=state.params, device=self.device,
                       mesh=self.mesh)
        twin.load_state(state)
        batches = self._timing_batches(arrays, bs, iters)
        noise = [self._rank_noise(self.noise_fn(self._host_step + i, bs,
                                                loss_fn),
                                  self._local_batch_size(bs))
                 for i in range(iters)]
        windows = []
        for w in range(4):
            twin._sync()
            t0 = time.perf_counter()
            for batch, eps in zip(batches, noise):
                twin.train_step(loss_fn, batch, eps)
            twin._sync()
            if w:                       # window 0 warms up
                windows.append((time.perf_counter() - t0) / iters)
        best = min(windows)
        return (best, windows) if spread else best

    def steady_state_step_time(self, arrays, variant: str = "default",
                               warmup: int = 3, iters: int = 20,
                               batch_size: Optional[int] = None) -> float:
        """Seconds per step of the live trainer (it takes warmup + 3 *
        iters steps on up to 8 batches of `arrays`, with one draw of
        noise), the best of three windows each ended by a device
        synchronise (and, with a mesh, a barrier: every rank calls it)."""
        bs = batch_size or self.cfg.batch_size
        loss_fn = self._loss_fns[variant]
        batches = self._timing_batches(arrays, bs, 8)
        eps = self._rank_noise(self.noise_fn(self._host_step, bs, loss_fn),
                               self._local_batch_size(bs))
        for i in range(warmup):
            self.train_step(loss_fn, batches[i % len(batches)], eps)
        self._sync()
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            for i in range(iters):
                self.train_step(loss_fn, batches[i % len(batches)], eps)
            self._sync()
            best = min(best, (time.perf_counter() - t0) / iters)
        return best
