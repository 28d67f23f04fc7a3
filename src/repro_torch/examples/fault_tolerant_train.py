"""Fault-tolerance demo: a training run that CRASHES twice mid-flight and
recovers from atomic checkpoints via the supervisor, finishing with the
exact same weights as an uninterrupted run (deterministic data order)
(port of ``examples/fault_tolerant_train.py``).

    PYTHONPATH=src python -m repro_torch.examples.fault_tolerant_train \
        [--device cpu]

The model is qwen2-1.5b reduced to 2 layers and a 512-token vocabulary (on
the card at head_dim 64, the smallest the kernels take).
"""
from __future__ import annotations

import argparse
import copy
import shutil
import time

from repro_torch import checkpoint as ckpt
from repro_torch.config import TrainConfig
from repro_torch.data import SyntheticCorpus
from repro_torch.ft import Supervisor
from repro_torch.launch import add_device_args, device_and_dtype, model_config
from repro_torch.train import trainer

CKPT = "artifacts/ckpt/ft-demo"


def main(argv=None, *, params=None, ckpt_dir: str = CKPT) -> dict:
    """``params``: the initial weights (default: seeded from 0 on the
    device; each run starts from its own copy); ``ckpt_dir``: where the
    checkpoints go (emptied first).  Returns the restarts, the kept
    checkpoints, the max parameter delta against the uninterrupted run and
    both runs' final states."""
    ap = argparse.ArgumentParser()
    add_device_args(ap)
    args = ap.parse_args(argv)
    dev, dtype = device_and_dtype(args)
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    cfg = model_config("qwen2-1.5b", True, dev, who="fault_tolerant_train",
                       n_layers=2, vocab_size=512)
    tcfg = TrainConfig(steps=30, batch_size=8, seq_len=64, lr=2e-3,
                       checkpoint_every=5, log_every=10)
    corpus = SyntheticCorpus(cfg.vocab_size, seed=0)
    crashes = {"at": [8, 19]}     # steps where a "node" dies

    def fresh():
        if params is None:
            return trainer.init_state(cfg, tcfg, device=dev, dtype=dtype)
        return trainer.state_for(copy.deepcopy(params))

    def train(start_step: int):
        state = fresh()
        if start_step:
            state, start_step = ckpt.restore(ckpt_dir, state)
            print(f"  -> resumed from step {start_step}")
        step = trainer.make_train_step(cfg, tcfg)
        for i in range(start_step, tcfg.steps):
            if crashes["at"] and i == crashes["at"][0]:
                crashes["at"].pop(0)
                raise RuntimeError(f"simulated hardware fault at step {i}")
            batch = trainer.batch_to(
                corpus.batch(i, tcfg.batch_size, tcfg.seq_len), dev)
            state, m = step(state, batch)
            if (i + 1) % tcfg.checkpoint_every == 0:
                ckpt.save(ckpt_dir, i + 1, state, keep=2)
            if i % tcfg.log_every == 0:
                print(f"  step {i}: loss={float(m['loss']):.4f}")
        return state

    sup = Supervisor(max_restarts=4)
    t0 = time.perf_counter()
    state = sup.run(lambda _: train(ckpt.latest_step(ckpt_dir) or 0))
    kept = ckpt.list_checkpoints(ckpt_dir)
    print(f"finished with {sup.restarts} restarts in "
          f"{time.perf_counter() - t0:.0f}s; checkpoints kept: {kept}")

    # verify bit-identical to an uninterrupted run
    ref = fresh()
    step = trainer.make_train_step(cfg, tcfg)
    for i in range(tcfg.steps):
        ref, _ = step(ref, trainer.batch_to(
            corpus.batch(i, tcfg.batch_size, tcfg.seq_len), dev))
    delta = max(float((a.detach() - b.detach()).abs().max())
                for a, b in zip(state["params"].parameters(),
                                ref["params"].parameters(), strict=True))
    print(f"max param delta vs uninterrupted run: {delta:.2e} "
          f"({'EXACT RECOVERY' if delta < 1e-5 else 'MISMATCH'})")
    return {"restarts": sup.restarts, "checkpoints": kept,
            "max_delta": delta, "state": state, "uninterrupted": ref}


if __name__ == "__main__":
    main()
