"""Serving engine: monolithic prefill + SALS decode over a slot arena (port
of ``repro/serve/engine.py::ServeEngine.generate``).

Batching is ragged: prompts are right-padded with ``scfg.pad_id`` and carry
their true lengths (per-slot ``lengths`` on the latent cache, per-row decode
positions through every kernel), so pad tokens are never selectable nor
attended.  Decoding is greedy; each row is truncated at its own EOS.

Not yet ported (later slices): chunked prefill and continuous admission,
the paged / tiered caches, speculative decoding, temperature sampling
(``torch.Generator`` numbers differ from ``jax.random``'s), and capturing
the decode step as a CUDA graph.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.config import ModelConfig, SALSConfig, ServeConfig
from repro_torch.models import transformer as tf


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (new_tokens,) generated ids
    prompt_len: int
    steps: int
    complete: bool = True


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device: the port's entry points run "
                               "on the card unless device='cpu' is passed")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class ServeEngine:
    """Holds params + projectors and runs batched greedy generation on
    ``device`` (the card unless the caller asks for the CPU).

    After :meth:`generate`, ``last_timing`` holds host wall times: prefill
    up to the first token on the host, and the decode steps after it."""

    def __init__(self, params, projectors, cfg: ModelConfig,
                 scfg: ServeConfig, n_groups: int = 1, device="cuda"):
        self.device = resolve_device(device)
        if not cfg.is_decoder:
            raise ValueError("encoder models cannot be served "
                             "autoregressively")
        self.params = params
        self.projectors = projectors
        self.cfg = cfg
        self.scfg = scfg
        self.sals: Optional[SALSConfig] = scfg.sals if (
            scfg.sals and scfg.sals.enabled and cfg.has_attention) else None
        if n_groups > 1:
            raise NotImplementedError("the grouped layout (n_groups > 1) is "
                                      "ported in the layouts slice")
        self.n_groups = n_groups
        if scfg.prefill_chunk < 1:
            raise ValueError("prefill_chunk must be >= 1")
        if scfg.max_seq_len % scfg.prefill_chunk:
            raise ValueError(f"max_seq_len {scfg.max_seq_len} must be a "
                             f"multiple of prefill_chunk {scfg.prefill_chunk}")
        if scfg.page_size > 0:
            raise NotImplementedError("the paged latent cache is ported in "
                                      "the serving-substrate slice (slice 2)")
        if scfg.spec_window > 1:
            raise NotImplementedError("speculative decoding is ported in "
                                      "slice 3")
        if self.sals is not None:
            if projectors is None or "u" not in projectors:
                raise ValueError("SALS needs calibrated projectors {'u': "
                                 "(L, kv_dim, r)}")
            u = projectors["u"]
            want = (cfg.n_layers, cfg.kv_dim, self.sals.rank(cfg.kv_dim))
            if tuple(u.shape) != want:
                raise ValueError(f"projectors['u'] is {tuple(u.shape)}, "
                                 f"expected {want}")
            if u.device != self.device:
                raise ValueError(f"projectors on {u.device}, engine on "
                                 f"{self.device}")
        p_dev = params.embed.embedding.device
        if p_dev != self.device:
            raise ValueError(f"params on {p_dev}, engine on {self.device}")
        self.last_timing: Optional[dict] = None

    # -- sampling ------------------------------------------------------------

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        if self.scfg.temperature > 0.0:
            raise NotImplementedError("temperature sampling is ported with "
                                      "the scheduler slice (greedy only)")
        return torch.argmax(logits, dim=-1).to(torch.int32)

    # -- public API ----------------------------------------------------------

    @torch.inference_mode()
    def generate(self, prompts: List[np.ndarray],
                 max_new_tokens: Optional[int] = None,
                 eos_id: Optional[int] = None) -> List[GenerationResult]:
        """Generate for a batch of prompts (each a 1-D int array).

        Rows finishing early (``eos_id``) are truncated at their own EOS:
        each row's result carries exactly the tokens up to and including
        its first EOS."""
        mnt = max_new_tokens or self.scfg.max_new_tokens
        b = len(prompts)
        lens = [len(p) for p in prompts]
        max_len = max(lens)
        if max_len + mnt > self.scfg.max_seq_len:
            raise ValueError(f"prompt {max_len} + new {mnt} exceeds max_seq "
                             f"{self.scfg.max_seq_len}")
        toks = np.full((b, max_len), self.scfg.pad_id, np.int32)
        for i, p in enumerate(prompts):
            toks[i, :lens[i]] = p
        dev = self.device
        t0 = time.perf_counter()
        pos0 = torch.as_tensor(lens, dtype=torch.int32, device=dev)
        logits, cache = tf.prefill(
            self.params, self.projectors, self.cfg, self.sals,
            {"tokens": torch.as_tensor(toks, device=dev)},
            self.scfg.max_seq_len, n_groups=self.n_groups, lengths=pos0)
        out = np.zeros((b, mnt), np.int32)
        done = np.zeros((b,), bool)
        n_out = np.zeros((b,), np.int32)
        next_tok = self._sample(logits)
        t_first = None
        for t in range(mnt):
            out[:, t] = next_tok.cpu().numpy()      # waits for the device
            if t_first is None:
                t_first = time.perf_counter()
            n_out[~done] = t + 1
            if eos_id is not None:
                done |= out[:, t] == eos_id
                if done.all():
                    break
            if t == mnt - 1:
                break
            logits, cache = tf.decode_step(self.params, self.projectors,
                                           cache, next_tok, pos0 + t,
                                           self.cfg, self.sals)
            next_tok = self._sample(logits)
        t_end = time.perf_counter()
        self.last_timing = {"prefill_s": t_first - t0,
                            "decode_s": t_end - t_first,
                            "decode_steps": int(n_out.max()) - 1}
        return [GenerationResult(out[i, :n_out[i]], lens[i], int(n_out[i]))
                for i in range(b)]
