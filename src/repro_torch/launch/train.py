"""Training launcher of the port (port of ``repro/launch/train.py``).

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-1.5b \
        [--reduced | --full] [--steps 200] [--microbatches 2] \
        [--remat none|block|save_dots] [--ckpt-dir artifacts/ckpt/qwen2] \
        [--checkpoint-every 50] [--resume] [--grad-compression] \
        [--device cpu] [--dtype bfloat16|float32]

Weights are random, from ``--seed``; the data is the synthetic corpus
(``SyntheticCorpus``, deterministic per step, so a resumed run sees the
batches an uninterrupted one would).  The step is
``trainer.make_train_step`` (AdamW with f32 master weights) driven by
``trainer.train_loop``, which checkpoints every ``--checkpoint-every``
steps into ``--ckpt-dir``.  With ``--resume`` the run starts from the
newest complete checkpoint there, and a supervisor restarts a failed run
from the newest one.

Runs on the card unless ``--device cpu`` is asked for.  The dtype defaults
to bfloat16 on the card (the flash kernels take bf16) and float32 on the
CPU.  ``--reduced`` (the default) is the tiny same-family configuration;
on the card its head_dim is raised from 32 to 64, the smallest the flash
kernels take (``launch.model_config``).  ``--full`` is the published
widths.  The encoder family (hubert-xlarge) trains on frames from the
reference's frontend stub (:func:`batches_for`).  ``--grad-compression``
takes ``trainer.make_compressed_train_step`` (int8 error-feedback
gradients, the residual ``ef`` in the state and its checkpoints).

Under ``torchrun`` (``python -m torch.distributed.run --standalone
--nproc-per-node N -m repro_torch.launch.train ...``) the launcher starts
the process group from torchrun's environment (NCCL on the card, gloo on
the CPU) and, as the reference does, builds the host mesh (1, N)
("data", "model") and its logical-axis rules (``default_rules``, no
sequence parallelism): the train state is placed by
``launch.specs.train_state_pspecs`` (TP over the ranks), each batch by
``batch_pspecs``, and the loop runs inside ``use_sharding``; checkpoints
are gathered and written by rank 0.  With ``--grad-compression`` the mesh
is (N, 1) and the int8 gradients reduce over ``mesh["data"]``'s group,
each rank training on its own rows.  Alone, it runs with no context, the
reference's mesh of one device.
"""
from __future__ import annotations

import argparse
import contextlib
from typing import Iterator, Optional

import numpy as np
import torch

from repro_torch import checkpoint as ckpt
from repro_torch.config import ModelConfig, TrainConfig
from repro_torch.configs import ASSIGNED_ARCHS, PAPER_ARCHS
from repro_torch.data import SyntheticCorpus, make_batches
from repro_torch.distributed import compression as gc
from repro_torch.ft import StragglerMonitor, run_with_restarts
from repro_torch.config import MeshConfig, ShapeConfig
from repro_torch.distributed import sharding as shd
from repro_torch.launch import add_device_args, device_and_dtype, model_config
from repro_torch.launch import specs
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.train import trainer


def frame_table(cfg: ModelConfig, device="cpu") -> torch.Tensor:
    """The encoder's frontend stub: a (vocab, d_model) f32 table of
    N(0, 0.02) rows, drawn on the CPU from a ``torch.Generator`` seeded 0
    (the reference draws its own from ``jax.random.PRNGKey(0)``), then
    moved to ``device``."""
    g = torch.Generator().manual_seed(0)
    return (torch.randn((cfg.vocab_size, cfg.d_model), generator=g)
            * 0.02).to(device)


def batches_for(cfg: ModelConfig, corpus: SyntheticCorpus,
                tcfg: TrainConfig, start_step: int,
                table: Optional[torch.Tensor] = None,
                device="cpu") -> Iterator[dict]:
    """The corpus's batches from ``start_step``.  A vlm batch also carries
    the reference's stub patch embeddings (N(0, 0.02) from seed 0).  An
    encoder batch is the reference's frontend stub: {"frames": the rows
    of ``table`` (default :func:`frame_table` on ``device``) at the
    tokens, "labels": labels % vocab}."""
    gen = make_batches(corpus, tcfg.batch_size, tcfg.seq_len, start_step)
    if cfg.family == "encoder":
        table = frame_table(cfg, device) if table is None else table

        def to_frames(b):
            tokens = torch.as_tensor(b["tokens"], device=table.device)
            return {"frames": table[tokens.long()],
                    "labels": b["labels"] % cfg.vocab_size}

        return (to_frames(b) for b in gen)
    if cfg.family != "vlm":
        return gen

    def add_patches(b):
        rng = np.random.default_rng(0)
        b = dict(b)
        b["patches"] = rng.normal(
            0, 0.02, (b["tokens"].shape[0], cfg.vision_patches, cfg.d_model)
        ).astype(np.float32)
        return b

    return (add_patches(b) for b in gen)


def main(argv=None) -> dict:
    """Parse ``argv``, train, and return the final train state."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True,
                    choices=ASSIGNED_ARCHS + PAPER_ARCHS)
    ap.add_argument("--reduced", action="store_true", default=True,
                    help="the tiny same-family config (the default); on "
                         "the card at head_dim 64, the smallest the "
                         "kernels take (the CPU keeps 32)")
    ap.add_argument("--full", dest="reduced", action="store_false")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch-size", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--grad-compression", action="store_true",
                    help="int8 error-feedback gradient reduction over the "
                         "torch.distributed world when it is initialized, "
                         "else over this rank alone")
    ap.add_argument("--remat", default="none",
                    choices=("none", "block", "save_dots"))
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--checkpoint-every", type=int,
                    default=TrainConfig.checkpoint_every)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--max-restarts", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0)
    add_device_args(ap)
    args = ap.parse_args(argv)

    dev, dtype = device_and_dtype(args)
    started = _init_from_torchrun(dev)
    try:
        return _run(args, dev, dtype)
    finally:
        if started:
            torch.distributed.destroy_process_group()


def _init_from_torchrun(dev: torch.device) -> bool:
    """Start the process group from torchrun's environment (RANK,
    WORLD_SIZE, MASTER_ADDR / MASTER_PORT) unless one is running.
    Returns whether it started one."""
    import os
    dist = torch.distributed
    if dist.is_initialized() or int(os.environ.get("WORLD_SIZE", "1")) < 2:
        return False
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        torch.cuda.set_device(local)
        dist.init_process_group("nccl", device_id=torch.device("cuda", local))
    else:
        dist.init_process_group("gloo")
    return True


def _run(args, dev: torch.device, dtype: torch.dtype) -> dict:
    cfg = model_config(args.arch, args.reduced, dev)
    tcfg = TrainConfig(steps=args.steps, batch_size=args.batch_size,
                       seq_len=args.seq_len, lr=args.lr,
                       microbatches=args.microbatches, seed=args.seed,
                       checkpoint_every=args.checkpoint_every)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=args.seed)
    world = gc.group_size()
    ranks, rank, group = 1, 0, None
    mesh = rules = None
    if args.grad_compression:
        ranks = world
        rank = torch.distributed.get_rank() if ranks > 1 else 0
        if ranks > 1:
            from torch.distributed.device_mesh import DeviceMesh
            group = DeviceMesh(dev.type, torch.arange(ranks).reshape(
                ranks, 1), mesh_dim_names=("data", "model")).get_group(
                "data")
        if tcfg.batch_size % ranks:
            raise ValueError(f"--batch-size {tcfg.batch_size} must be a "
                             f"multiple of the {ranks} ranks")
        print(f"[train] int8 error-feedback gradients over {ranks} "
              f"rank{'s' if ranks > 1 else ''} (rank {rank})")
    elif world > 1:
        mesh = make_host_mesh(device=dev)
        mesh_cfg = MeshConfig(shape=tuple(mesh.shape),
                              axis_names=("data", "model"),
                              seq_parallel=False)
        shape = ShapeConfig("cli", "train", tcfg.seq_len, tcfg.batch_size)
        rules = shd.default_rules(mesh_cfg, shape)
        batch_pl = shd.tree_shardings(
            mesh, specs.batch_pspecs(cfg, shape, rules))
        print(f"[train] mesh {tuple(mesh.shape)} (data, model) over "
              f"{world} ranks")

    def rank_rows(batches):
        """This rank's rows of each global batch (the reference's batch
        sharded over its data axis); the whole batch on one rank."""
        per = tcfg.batch_size // ranks
        for b in batches:
            yield {k: v[rank * per:(rank + 1) * per] for k, v in b.items()}

    def placed(batches):
        """Each global batch as DTensors placed by the rules."""
        for b in batches:
            yield shd.place(trainer.batch_to(b, dev), mesh, batch_pl)

    def train_once(start_step: int):
        state = trainer.init_state(cfg, tcfg, device=dev, dtype=dtype,
                                   ef_residual=args.grad_compression)
        if mesh is not None:
            pl = shd.tree_shardings(mesh, specs.train_state_pspecs(
                cfg, tcfg, mesh, state))
            state = {k: shd.place(v, mesh, pl[k]) for k, v in state.items()}
        if start_step and args.ckpt_dir:
            state, start_step = ckpt.restore(args.ckpt_dir, state)
            print(f"[train] restored step {start_step}")
        if args.grad_compression:
            step_fn = trainer.make_compressed_train_step(
                cfg, tcfg, group, remat=args.remat)
        else:
            step_fn = trainer.make_train_step(cfg, tcfg, remat=args.remat)
        mon = StragglerMonitor()
        batches = batches_for(cfg, corpus, tcfg, start_step, device=dev)
        with shd.use_sharding(mesh, rules) if mesh is not None \
                else contextlib.nullcontext():
            # a sharded state is gathered and written by every rank
            # together; a replicated one by rank 0
            state = trainer.train_loop(
                cfg, tcfg, state=state, step_fn=step_fn,
                batches=placed(batches) if mesh is not None
                else rank_rows(batches),
                start_step=start_step,
                ckpt_dir=(args.ckpt_dir or None)
                if rank == 0 or mesh is not None else None,
                straggler=mon)
        if mon.flags:
            print(f"[train] straggler steps flagged: {mon.flags[:5]}")
        return state

    if args.ckpt_dir and args.resume:
        # the first attempt also starts from the newest checkpoint
        return run_with_restarts(
            lambda start: train_once(
                start or ckpt.latest_step(args.ckpt_dir) or 0),
            args.ckpt_dir, max_restarts=args.max_restarts)
    return train_once(0)


if __name__ == "__main__":
    main()
