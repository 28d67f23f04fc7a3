"""Training step and loop (port of ``repro/train/trainer.py``):
microbatch gradient accumulation, remat, optional int8 error-feedback
gradient compression, checkpoint / restart integration.

``make_train_step`` builds ``step(state, batch) -> (state, metrics)``; the
state is updated IN PLACE (the counterpart of the reference's
``jax.jit(step, donate_argnums=(0,))``) and the step runs eagerly.
``make_compressed_train_step`` reduces the gradients over a
``torch.distributed`` group with int8 codes on the wire
(``distributed/compression.py``), carrying each rank's quantization error
in ``state["ef"]``.  ``train_loop`` is the host driver (data, checkpoints,
straggler timing, logging).
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.distributed import compression as gc
from repro_torch.distributed.sharding import replicated
from repro_torch.models import transformer as tf
from repro_torch.train.optimizer import adamw_init, adamw_update

TrainState = Dict[str, Any]     # {"params": Transformer, "opt": {...}[,
                                #  "ef": {name: f32 residual}]}
AUX_WEIGHT = 0.01   # MoE load-balance loss weight


def init_state(cfg: ModelConfig, tcfg: TrainConfig, device="cuda",
               dtype=None, moment_dtype=torch.float32,
               generator: Optional[torch.Generator] = None,
               seed: Optional[int] = None,
               ef_residual: bool = False) -> TrainState:
    """Seeded parameters (``seed`` defaults to ``tcfg.seed``) with their
    gradients turned on, a fresh AdamW state and, with ``ef_residual``, a
    zero error-feedback residual ``ef`` for the compressed step."""
    params = tf.init_params(cfg, generator, device=device, dtype=dtype,
                            seed=tcfg.seed if seed is None else seed)
    return state_for(params, moment_dtype, ef_residual)


def state_for(params: tf.Transformer, moment_dtype=torch.float32,
              ef_residual: bool = False) -> TrainState:
    """A train state over existing parameters: their gradients on, AdamW
    state zero (and a zero ``ef`` residual with ``ef_residual``)."""
    params.requires_grad_(True)
    state = {"params": params, "opt": adamw_init(params, moment_dtype)}
    if ef_residual:
        state["ef"] = gc.init_residual(params)
    return state


def loss_fn(params: tf.Transformer, cfg: ModelConfig, batch: dict,
            remat: str = "none", ce_chunk: int = 512
            ) -> Tuple[torch.Tensor, dict]:
    ce, aux = tf.forward_loss(params, cfg, batch, remat=remat,
                              ce_chunk=ce_chunk)
    loss = ce + AUX_WEIGHT * aux
    return loss, {"ce": ce, "aux": aux}


def loss_and_grads(params: tf.Transformer, cfg: ModelConfig, batch: dict,
           remat: str):
    """(loss, extras, {name: grad in the parameter's dtype}); over a
    sharded state the loss and extras come back whole on every rank."""
    names, leaves = zip(*params.named_parameters())
    loss, extras = loss_fn(params, cfg, batch, remat)
    grads = torch.autograd.grad(loss, leaves, materialize_grads=True)
    return replicated(loss.detach()), \
        {k: replicated(v.detach()) for k, v in extras.items()}, \
        dict(zip(names, grads))


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, *,
                    remat: str = "none") -> Callable:
    """Returns step(state, batch) -> (state, metrics).

    Microbatch accumulation: the batch is split on axis 0 into
    ``tcfg.microbatches`` slices run in turn; their gradients accumulate
    in f32, each divided by the count, and the loss and extras are the
    slices' means (the reference's ``scan``)."""

    def step(state: TrainState, batch: dict):
        params = state["params"]
        mb = tcfg.microbatches
        if mb <= 1:
            loss, extras, grads = loss_and_grads(params, cfg, batch, remat)
        else:
            grads, losses, extra_seq = None, [], []
            for i in range(mb):
                part = {k: v.reshape(mb, v.shape[0] // mb, *v.shape[1:])[i]
                        for k, v in batch.items()}
                l, ex, g = loss_and_grads(params, cfg, part, remat)
                losses.append(l)
                extra_seq.append(ex)
                if grads is None:
                    grads = {k: torch.zeros_like(p, dtype=torch.float32)
                             for k, p in params.named_parameters()}
                for k, gi in g.items():
                    grads[k] += gi.float() / mb
            loss = torch.stack(losses).mean()
            extras = {k: torch.stack([e[k] for e in extra_seq]).mean()
                      for k in extra_seq[0]}
        _, _, om = adamw_update(grads, state["opt"], params, tcfg)
        return state, {"loss": loss, **extras, **om}

    return step


def make_compressed_train_step(cfg: ModelConfig, tcfg: TrainConfig,
                               group=None, *, remat: str = "none"
                               ) -> Callable:
    """The data-parallel step with int8 error-feedback compression: each
    rank's loss and gradients on its own batch, the gradients mean-reduced
    over ``group`` by ``compressed_mean_grads`` (``state["ef"]`` updated in
    place), the loss and extras averaged over it, then AdamW.  ``group``
    None is the world when ``torch.distributed`` is initialized, else this
    rank alone (the reference's one-device mesh)."""

    def step(state: TrainState, batch: dict):
        params = state["params"]
        loss, extras, grads = loss_and_grads(params, cfg, batch, remat)
        grads, _ = gc.compressed_mean_grads(grads, state["ef"], group)
        loss = gc.mean_over(loss, group)
        extras = {k: gc.mean_over(v, group) for k, v in extras.items()}
        _, _, om = adamw_update(grads, state["opt"], params, tcfg)
        return state, {"loss": loss, **extras, **om}

    return step


def batch_to(batch: dict, device) -> Dict[str, torch.Tensor]:
    """A numpy batch (the corpus's) as tensors on ``device``."""
    return {k: torch.as_tensor(v).to(device) for k, v in batch.items()}


def train_loop(cfg: ModelConfig, tcfg: TrainConfig, *, state: TrainState,
               step_fn: Callable, batches, start_step: int = 0,
               ckpt_dir: Optional[str] = None, straggler=None,
               log: Callable = print,
               on_step: Optional[Callable[[int, dict, float], None]] = None
               ) -> TrainState:
    """Host driver: steps, periodic checkpoints, straggler timing.
    ``on_step(step, metrics, seconds)`` (optional) sees each step's
    metrics (device tensors) and the wall seconds since the previous step
    ended."""
    from repro_torch import checkpoint as ckpt

    device = next(state["params"].parameters()).device
    t_last = time.perf_counter()
    for step_i in range(start_step, tcfg.steps):
        batch = batch_to(next(batches), device)
        state, metrics = step_fn(state, batch)
        if straggler is not None or on_step is not None:
            if device.type == "cuda":
                torch.cuda.synchronize(device)
            now = time.perf_counter()
            if straggler is not None:
                straggler.record(step_i, now - t_last)
            if on_step is not None:
                on_step(step_i, metrics, now - t_last)
            t_last = time.perf_counter()
        if step_i % tcfg.log_every == 0 or step_i == tcfg.steps - 1:
            m = {k: float(v) for k, v in metrics.items()}
            log(f"step {step_i}: loss={m['loss']:.4f} ce={m['ce']:.4f} "
                f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.3f}")
        if ckpt_dir and (step_i + 1) % tcfg.checkpoint_every == 0:
            ckpt.save(ckpt_dir, step_i + 1, state,
                      keep=tcfg.keep_checkpoints)
    return state
