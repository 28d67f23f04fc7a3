"""Serving engine: chunked prefill + SALS decode over a slot arena (port of
``repro/serve/engine.py``).

Batching is ragged: prompts are right-padded with ``scfg.pad_id`` and carry
their true lengths (per-slot ``lengths`` on the latent cache, per-row decode
positions through every kernel), so pad tokens are never selectable nor
attended.  Decoding is greedy at ``temperature`` 0, else a draw from
``softmax(logits / temperature)`` by Gumbel-max with the engine's own
``torch.Generator``, seeded from ``scfg.seed`` at the start of every
:meth:`~ServeEngine.generate` and every scheduler run (the streams differ
from ``jax.random``'s; the distribution is the same).  Sampling runs on the
step program's logits, outside the captured graph.

Three ways in.  :meth:`ServeEngine.generate` prefills a batch
monolithically and decodes it to the end; :meth:`~ServeEngine.
generate_speculative` does the same through the speculative verify window
(prompt-lookup drafts, one windowed forward per round, the longest
matching prefix committed).  The continuous-batching primitives that
``serve/scheduler.py`` drives let a single request join a RUNNING batch:
:meth:`~ServeEngine.start_prefill` / :meth:`~ServeEngine.prefill_chunk_step`
run its prompt as fixed-width chunks (resumable between decode steps, so
admission work interleaves with decoding), and :meth:`~ServeEngine.admit`
(dense slot arena) or :meth:`~ServeEngine.admit_paged` (page pool) splice
the finished single-request cache into a free slot.  With ``page_size`` >
0 the SALS segments live in a refcounted page pool (``core/pager.py`` keeps
the host bookkeeping) with prefix sharing and copy-on-write.

With ``hbm_pages`` > 0 the pool is TWO-TIER (``core/tiering.py`` keeps the
residency state): the payload pools hold ``hbm_pages`` device slots, the
r* score pool every live page, and cold payloads live in host mirrors —
{segment: {field: (ls, ps, ·) tensor}} in pinned host memory on the card.
:meth:`~ServeEngine.read_page_payload` (spill), :meth:`~ServeEngine.
load_page` (fetch) and :meth:`~ServeEngine.extract_page_payload_dense`
(cold admission) copy on a dedicated copy stream; events order each spill
after the work already queued on the compute stream and before any later
compute-stream use of its slot, and each fetch before the step that reads
it.  Copies do not overlap compute yet.

The reference's arrays are immutable; the port's caches are updated IN
PLACE.  Everything that must outlive the next write — a prefix-cache
entry's resume state (:meth:`~ServeEngine.prefill_state_copy`), a
page-boundary ring snapshot — is therefore a copy, never a view.

The reference compiles its four decode steps and its chunk step with
``jax.jit``; here ``_decode``, ``_decode_sel``, ``_decode_window``,
``_commit_window`` and ``_prefill_chunk`` are :class:`~repro_torch.serve.
step_graph.StepGraph` s: on the card each step (every layer, the SALS
kernels, the final norm and unembedding) is one CUDA graph, captured on a
key's first call and replayed after.  Every decode path goes through them
(:meth:`~ServeEngine.decode`, :meth:`~ServeEngine.decode_sel`,
:meth:`~ServeEngine.decode_window`, :meth:`~ServeEngine.commit_window`,
:meth:`~ServeEngine.generate`, :meth:`~ServeEngine.generate_speculative`,
and so the scheduler), and every chunk of a chunked prefill
(:meth:`~ServeEngine.prefill_chunk_step`).  Their outputs (the logits, a
window's ``aux``) belong to the graph and are overwritten by its next
call.

Chunked prefill runs in ONE prefill workspace per engine, the counterpart
of the buffers the reference's chunk step donates: a single-slot cache and
SALS scratch at ``max_seq_len``, allocated on the first
:meth:`~ServeEngine.start_prefill` and reset in place by every later one,
so the chunk program keeps one key for the engine's life.  A task's
``cache``, ``scratch`` and ``logits`` are therefore valid until the next
``start_prefill`` (logits: the next chunk); what outlives that takes a
copy.  Monolithic prefill and the cache upkeep (admission, page copies)
run eagerly.

PARK / RESUME (the scheduler's preemption): :meth:`~ServeEngine.
detach_slot` copies a slot's per-slot state — the latent segments' windows
and length, whole slot rows of the full-precision segments — to host
memory, and :meth:`~ServeEngine.attach_slot` writes it back into a batch
row IN PLACE (the arena's storages, and so the step programs' keys, never
change).  The paged per-token payload stays in the pool: the parked
request keeps its pages.
"""
from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Tuple

import numpy as np
import torch

from repro_torch.config import ModelConfig, SALSConfig, ServeConfig
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.kernels.latent_score import BLOCK_S
from repro_torch.models import transformer as tf
from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import trace as obs_trace
from repro_torch.serve.draft import NgramDrafter
from repro_torch.serve.faults import maybe_fault
from repro_torch.serve.step_graph import StepGraph, copy_tree, tree_tensors

_PAGED_FIELDS = ("k_lat", "k_scale", "v_q", "v_scale", "v_zero")
_WINDOW_FIELDS = ("sink_k", "sink_v", "recent_k", "recent_v")
# Per-slot state a PARK carries across the slot release: the attention
# windows + the slot length (the paged payload stays in the pool; the
# page-table row is host state, reinstalled through with_page_tables)
_PARK_FIELDS = _WINDOW_FIELDS + ("lengths",)


def _clone_state(tree):
    """Own copy of a cache or scratch tree (dicts of tensors and
    ``LatentKVCache`` s)."""
    if isinstance(tree, LatentKVCache):
        return dataclasses.replace(tree, **{
            f.name: getattr(tree, f.name).clone()
            for f in dataclasses.fields(tree)
            if isinstance(getattr(tree, f.name), torch.Tensor)})
    return {k: _clone_state(v) if isinstance(v, (dict, LatentKVCache))
            else v.clone() for k, v in tree.items()}


@dataclasses.dataclass
class GenerationResult:
    tokens: np.ndarray          # (new_tokens,) generated ids
    prompt_len: int
    steps: int
    # False: a partial stream flushed by a non-DONE teardown of a
    # streaming request (``tokens`` holds what was committed before it died)
    complete: bool = True


@dataclasses.dataclass
class PrefillTask:
    """One request's chunked prefill in flight.

    Created by :meth:`ServeEngine.start_prefill`; each
    :meth:`ServeEngine.prefill_chunk_step` advances it by one chunk.
    ``cache`` is the single-slot decode cache being built (dense) and
    ``scratch`` the SALS prompt-K/V buffer, both the engine's prefill
    workspace (rewritten by the next ``start_prefill``); ``logits`` holds
    the last chunk's last-real-token logits (after the final chunk: the
    prompt's next-token logits), the chunk program's output (rewritten by
    the next chunk).  ``start_chunk`` > 0: resumed from a prefix-cache
    entry at a page boundary; ``boundary_rings`` {n_pages: SALS ring
    snapshot} feeds later prefix-cache entries."""

    tokens: np.ndarray           # (1, n_chunks·C) right-padded prompt
    prompt_len: int
    cache: dict
    scratch: dict
    n_chunks: int
    next_chunk: int = 0
    logits: Optional[torch.Tensor] = None
    start_chunk: int = 0
    boundary_rings: Optional[dict] = None

    @property
    def done(self) -> bool:
        return self.next_chunk >= self.n_chunks


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
    """Holds params + projectors and runs batched generation (greedy, or
    sampled at ``scfg.temperature``) on ``device`` (the card unless the
    caller asks for the CPU).

    After :meth:`generate` (and :meth:`generate_speculative`),
    ``last_timing`` holds host wall times: prefill up to the first token on
    the host, the decode steps (verify rounds) after it, and apart from
    them the capture of the step graphs (``capture_s``)."""

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
        if scfg.page_size > 0 and self.sals is None:
            raise ValueError("page_size > 0 needs SALS latent segments "
                             "(sals enabled on an attention family) — the "
                             "page pool backs the compressed cache")
        if self.paged:
            bs = min(BLOCK_S, scfg.max_seq_len)
            if bs % scfg.page_size:
                raise ValueError(
                    f"page_size {scfg.page_size} must divide the score "
                    f"kernel's seq block min(block_s={BLOCK_S}, "
                    f"max_seq_len={scfg.max_seq_len}) = {bs}")
            if scfg.pool_pages * scfg.page_size < scfg.max_seq_len:
                raise ValueError(
                    f"pool of {scfg.pool_pages} pages cannot hold one "
                    f"max_seq_len {scfg.max_seq_len} sequence")
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
        self._stream: Optional[torch.cuda.Stream] = None   # tier copies
        # temperature sampling's stream, reseeded by reset_sampler
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(scfg.seed)
        # (cache, scratch) of chunked prefill, made by the first
        # start_prefill (engines that only generate never pay for it)
        self._workspace: Optional[Tuple[dict, dict]] = None

        # the reference's compiled chunk step and four decode programs
        # (repro/serve/engine.py:154-164), keyed on the params and
        # projectors besides their own arguments
        def keyed():
            return self.params, self.projectors

        self._prefill_chunk = StepGraph(self._prefill_chunk_impl,
                                        self.device, (0, 1, 2), keyed)

        self._decode = StepGraph(self._decode_impl, self.device, (0, 2),
                                 keyed)
        self._decode_sel = StepGraph(self._decode_sel_impl, self.device,
                                     (0, 2), keyed)
        self._decode_window = StepGraph(self._decode_window_impl,
                                        self.device, (0, 2), keyed)
        self._commit_window = StepGraph(self._commit_window_impl,
                                        self.device, (2, 3), keyed)

    @property
    def paged(self) -> bool:
        """SALS segments backed by the refcounted page pool instead of the
        dense slot arena."""
        return self.sals is not None and self.scfg.page_size > 0

    @property
    def tiered(self) -> bool:
        """Two-tier page pool: payload pools hold ``scfg.hbm_pages`` hot
        device slots; the r* score pool keeps every live page resident,
        cold payloads live in host mirrors."""
        return self.paged and self.scfg.hbm_pages > 0

    # -- sampling ------------------------------------------------------------

    def reset_sampler(self) -> None:
        """Reseed the sampling generator from ``scfg.seed`` (where the
        reference makes its ``PRNGKey``)."""
        self._gen.manual_seed(self.scfg.seed)

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Argmax at temperature 0; else one categorical draw per row from
        ``softmax(logits / T)`` by Gumbel-max (``jax.random.categorical``'s
        method), uniforms from the engine's generator.  A NaN row samples
        some in-vocab id; ``sample_checked`` flags it."""
        t = self.scfg.temperature
        if t <= 0.0:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        u = torch.rand(logits.shape, generator=self._gen,
                       device=logits.device)
        gumbel = -torch.log(-torch.log(u))
        return torch.argmax(logits.float() / t + gumbel,
                            dim=-1).to(torch.int32)

    def sample_checked(self, logits: torch.Tensor
                       ) -> Tuple[torch.Tensor, np.ndarray]:
        """Sample plus a per-row verdict: ``ok[i]`` is False when row i's
        logits hold NaN/inf or the id falls outside the vocab — the
        scheduler fails only the flagged rows."""
        tok = self._sample(logits)
        finite = torch.isfinite(logits).all(dim=-1)
        in_vocab = (tok >= 0) & (tok < self.cfg.vocab_size)
        return tok, (finite & in_vocab).cpu().numpy()

    def verify_checked(self, win_logits: torch.Tensor
                       ) -> Tuple[np.ndarray, np.ndarray]:
        """Greedy continuations of a verify window plus a per-row verdict:
        (preds (B, Q) int32, ok (B,) bool — False when row i's window
        logits hold NaN/inf).  The one host read of a round."""
        preds = torch.argmax(win_logits, dim=-1).to(torch.int32)
        finite = torch.isfinite(win_logits).all(dim=-1).all(dim=-1)
        return preds.cpu().numpy(), finite.cpu().numpy()

    # -- continuous-batching primitives (used by RequestScheduler) -----------

    def _latent_segs(self, cache) -> dict:
        return {k: seg for k, seg in cache.items()
                if isinstance(seg, LatentKVCache)}

    def init_slot_cache(self) -> dict:
        """Zeroed decode cache with ``max_batch`` slots (paged: pools of
        ``pool_pages + 1`` pages — physical page 0 is the trash page that
        unmapped table entries and idle slots' writes land in)."""
        return tf.init_cache(self.cfg, self.sals, self.scfg.max_batch,
                             self.scfg.max_seq_len, n_groups=self.n_groups,
                             page_size=self.scfg.page_size if self.paged
                             else 0, n_pages=self.scfg.pool_pages + 1,
                             hbm_pages=self.scfg.hbm_pages if self.paged
                             else 0, device=self.device)

    # -- the step programs (the reference's jitted bodies) ------------------

    def _prefill_chunk_impl(self, tokens, off, lengths, cache, scratch):
        return tf.prefill_chunk(self.params, self.projectors, self.cfg,
                                self.sals, cache, scratch,
                                {"tokens": tokens}, off, lengths)[0]

    def _decode_impl(self, tokens, cache, pos):
        return tf.decode_step(self.params, self.projectors, cache, tokens,
                              pos, self.cfg, self.sals)[0]

    def _decode_sel_impl(self, tokens, cache, pos):
        logits, _, touched = tf.decode_step(
            self.params, self.projectors, cache, tokens, pos, self.cfg,
            self.sals, collect_selection=True)
        union = torch.zeros((tokens.shape[0], self.scfg.max_seq_len
                             // self.scfg.page_size), dtype=torch.bool,
                            device=self.device)
        for seg_touch in touched.values():          # (ls, B, max_pages)
            union |= seg_touch.any(dim=0)
        return logits, union

    def _decode_window_impl(self, tokens, cache, pos):
        return tf.decode_window(self.params, self.projectors, cache, tokens,
                                pos, self.cfg, self.sals)

    def _commit_window_impl(self, cache, aux, pos, n_accept):
        tf.commit_window(self.projectors, cache, aux, pos, n_accept,
                         self.cfg, self.sals)

    # -- decode entries (tokens, positions, n_accept: host arrays or tensors
    # on the engine's device; the outputs are the step program's) ----------

    def decode(self, tokens, cache: dict, positions) -> Tuple[torch.Tensor,
                                                              dict]:
        """One ragged decode step of the whole arena (tokens, positions:
        (B,)); updates ``cache`` in place.  Returns (logits (B, V) f32,
        cache); the logits are overwritten by the next step."""
        return self._decode(tokens, cache, positions), cache

    def decode_sel(self, tokens, cache: dict, positions
                   ) -> Tuple[torch.Tensor, dict, torch.Tensor]:
        """:meth:`decode` that also reports which logical pages the SALS
        selection reconstructed from, unioned over layers into one
        (B, max_pages) bool mask: the tiered fetch-and-rerun loop's
        residency probe (``RequestScheduler``)."""
        logits, union = self._decode_sel(tokens, cache, positions)
        return logits, cache, union

    def decode_window(self, tokens, cache: dict, positions
                      ) -> Tuple[torch.Tensor, dict]:
        """One verify window of the whole arena: tokens (B, Q) = each row's
        pending token plus Q−1 drafts, positions (B,) the window bases.
        Reads the SALS caches only; returns (logits (B, Q, V), aux) for
        :meth:`commit_window`, both overwritten by the next window."""
        return self._decode_window(tokens, cache, positions)

    def commit_window(self, cache: dict, aux: dict, positions,
                      n_accept) -> dict:
        """Commit each row's first ``n_accept[i]`` window slots at
        positions[i]..; rejected and idle rows (0) write nothing.  Without
        SALS segments there is nothing to commit: the full-precision
        layers hold the window's K/V already."""
        if self.sals is not None:
            self._commit_window(cache, aux, positions, n_accept)
        return cache

    def start_prefill(self, prompt: np.ndarray,
                      resume: Optional[Tuple] = None) -> PrefillTask:
        """Begin a chunked prefill for ONE request: the prompt is
        right-padded to whole ``prefill_chunk`` chunks.  ``resume`` =
        (prefix entry, n_shared_pages) seeds the task from the entry
        (:meth:`resume_seed`) and starts at that page boundary, so only the
        suffix chunks run.  The task's cache and scratch are the engine's
        prefill workspace, reset in place here: the previous task's state
        is gone (:meth:`prefill_state_copy` keeps it)."""
        plen = len(prompt)
        if plen > self.scfg.max_seq_len:
            raise ValueError(f"prompt {plen} exceeds max_seq "
                             f"{self.scfg.max_seq_len}")
        c = self.scfg.prefill_chunk
        n = max(1, -(-plen // c))
        toks = np.full((1, n * c), self.scfg.pad_id, np.int32)
        toks[0, :plen] = prompt
        if resume is not None:
            maybe_fault("prefix_resume")
            entry, n_shared = resume
            start = n_shared * self.scfg.page_size // c
            if not 0 < start < n:
                raise ValueError(f"resume boundary {n_shared} pages does "
                                 f"not leave a suffix chunk (prompt {plen})")
            cache, scratch = self.resume_seed(entry, n_shared)
            return PrefillTask(tokens=toks, prompt_len=plen, cache=cache,
                               scratch=scratch, n_chunks=n,
                               next_chunk=start, start_chunk=start)
        cache, scratch = self._reset_workspace()
        return PrefillTask(tokens=toks, prompt_len=plen, cache=cache,
                           scratch=scratch, n_chunks=n)

    @torch.inference_mode()
    def _reset_workspace(self, src: Optional[Tuple[dict, dict]] = None
                         ) -> Tuple[dict, dict]:
        """The prefill workspace (cache, scratch), reset in place: zeroed,
        exactly what ``tf.init_cache`` / ``tf.init_prefill_scratch`` give
        for one slot, or a copy of ``src``.  Allocated on the first call.
        A reset waits for the tier copy stream's reads of the previous
        task's cache (the cold mirrors of a tiered admission)."""
        if self._workspace is None:
            s = self.scfg.max_seq_len
            self._workspace = (
                tf.init_cache(self.cfg, self.sals, 1, s,
                              n_groups=self.n_groups, device=self.device),
                tf.init_prefill_scratch(self.cfg, self.sals, 1, s,
                                        device=self.device))
        else:
            if self._stream is not None:
                torch.cuda.current_stream(self.device).wait_stream(
                    self._stream)
            if src is None:
                for t in tree_tensors(self._workspace):
                    t.zero_()
        if src is not None:
            copy_tree(self._workspace, src)
        return self._workspace

    def prefill_state_copy(self, task: PrefillTask) -> Tuple[dict, dict]:
        """Own copies of a finished task's (cache, scratch), which live in
        the prefill workspace until the next :meth:`start_prefill`: what a
        prefix-cache entry keeps."""
        return _clone_state(task.cache), _clone_state(task.scratch)

    def prefill_chunk_step(self, task: PrefillTask) -> bool:
        """Advance ``task`` by one chunk; True when the prompt is done
        (``task.logits`` then holds the next-token logits and
        ``task.cache`` the finished single-slot cache)."""
        c = self.scfg.prefill_chunk
        j = task.next_chunk
        maybe_fault("prefill_chunk")      # before the task's cache changes
        task.logits = self._prefill_chunk(
            task.tokens[:, j * c:(j + 1) * c], np.int32(j * c),
            np.array([task.prompt_len], np.int32), task.cache, task.scratch)
        task.next_chunk += 1
        if self.paged and self.scfg.prefix_cache:
            # page-boundary ring snapshot: the one non-append-only piece of
            # prefill state a prefix-cache resume needs, for the first
            # prefix_share_pages boundaries (shared prefixes are prompt
            # heads), cloned because the next chunk rewrites the ring
            ps = self.scfg.page_size
            off_end = task.next_chunk * c
            if off_end % ps == 0 and off_end <= task.prompt_len \
                    and off_end // ps <= self.scfg.prefix_share_pages:
                if task.boundary_rings is None:
                    task.boundary_rings = {}
                task.boundary_rings[off_end // ps] = \
                    self.sals_ring_state(task.cache)
        return task.done

    def prefill_one(self, prompt: np.ndarray) -> Tuple[torch.Tensor, dict]:
        """Prefill ONE request by draining its chunk loop.  Returns (logits
        (1, V) at the last real token, the caller's own copy; single-slot
        cache, the prefill workspace, valid until the next
        :meth:`start_prefill`)."""
        task = self.start_prefill(prompt)
        while not task.done:
            self.prefill_chunk_step(task)
        return task.logits.clone(), task.cache

    def admit(self, cache: dict, one_cache: dict, slot: int) -> dict:
        """Copy a prefilled single-request cache into batch row ``slot`` of
        the dense slot arena, in place."""
        maybe_fault("admit")              # before the arena changes
        for k, seg in cache.items():
            one = one_cache[k]
            if isinstance(seg, LatentKVCache):
                seg.prefill_into_slot(slot, one)
            else:
                for name, arr in seg.items():
                    arr[:, slot] = one[name][:, 0]
        return cache

    def admit_paged(self, cache: dict, one_cache: dict, slot: int, page_ids,
                    start_page: int, prompt_len: int) -> dict:
        """Paged admission, in place: the task's SALS per-token rows of
        logical pages [start_page, ceil(prompt_len / ps)) go into the pool
        pages ``page_ids`` names; shared prefix pages [0, start_page) are
        not written (their bytes already live in the pool, stored once).
        The windows, the length and the page-table row are set per slot;
        full-precision segments are row splices as in :meth:`admit`."""
        return self._admit_pages(cache, one_cache, slot, page_ids, None,
                                 start_page, prompt_len)

    def admit_tiered(self, cache: dict, one_cache: dict, slot: int,
                     page_ids, hot_slots, start_page: int,
                     prompt_len: int) -> dict:
        """Tiered admission, in place: as :meth:`admit_paged`, but the
        payload rows of page j go into hot SLOT ``hot_slots[j]`` (0: the
        page was admitted cold, its payload goes to a host mirror instead,
        :meth:`extract_page_payload_dense`, and nothing lands here), while
        every page's leading r* rows go into the score pool at its
        physical page.  Installs both table rows of the slot."""
        return self._admit_pages(cache, one_cache, slot, page_ids, hot_slots,
                                 start_page, prompt_len)

    def _admit_pages(self, cache: dict, one_cache: dict, slot: int, page_ids,
                     hot_slots, start_page: int, prompt_len: int) -> dict:
        maybe_fault("admit")              # before the arena changes
        ps = self.scfg.page_size
        mp = self.scfg.max_seq_len // ps
        row = np.zeros((mp,), np.int32)
        row[:len(page_ids)] = list(page_ids)
        take = np.arange(start_page, -(-prompt_len // ps))
        pay_row, take_pay = row, take     # payload pool index of each page
        if hot_slots is not None:
            pay_row = np.zeros((mp,), np.int32)
            pay_row[:len(hot_slots)] = list(hot_slots)
            take_pay = take[pay_row[take] > 0]

        def dev(a):
            return torch.as_tensor(a, dtype=torch.long, device=self.device)

        for k, seg in cache.items():
            one = one_cache[k]
            if not isinstance(seg, LatentKVCache):
                for name, arr in seg.items():
                    arr[:, slot] = one[name][:, 0]
                continue

            def pages(name):                      # (L, mp, ps, ·) view
                dense = getattr(one, name)        # (L, 1, S, ·)
                return dense.reshape(dense.shape[0], mp, ps,
                                     *dense.shape[3:])

            for name in _PAGED_FIELDS:
                pool = getattr(seg, name)
                if pool is not None:
                    pool[:, dev(pay_row[take_pay])] = \
                        pages(name)[:, dev(take_pay)].to(pool.dtype)
            if seg.tiered:
                r_star = seg.k_score.shape[-1]
                seg.k_score[:, dev(row[take])] = \
                    pages("k_lat")[:, dev(take), :, :r_star]
                if seg.k_scale_score is not None:
                    seg.k_scale_score[:, dev(row[take])] = \
                        pages("k_scale")[:, dev(take)]
                seg.hot_table[:, slot] = torch.as_tensor(pay_row,
                                                         device=self.device)
            for name in _WINDOW_FIELDS:
                getattr(seg, name)[:, slot] = getattr(one, name)[:, 0]
            seg.lengths[:, slot] = prompt_len
            seg.page_table[:, slot] = torch.as_tensor(row, device=self.device)
        return cache

    def copy_page(self, cache: dict, src: int, dst: int) -> dict:
        """Device half of copy-on-write: duplicate pool page ``src`` into
        ``dst`` in every SALS segment and layer (tiered: payload SLOTS)."""
        maybe_fault("cow_copy")           # before the pool changes
        for seg in self._latent_segs(cache).values():
            for name in _PAGED_FIELDS:
                pool = getattr(seg, name)
                if pool is not None:
                    pool[:, dst] = pool[:, src]
        return cache

    # -- two-tier transfers (host mirrors; see the module docstring) ---------

    def _copy_stream(self) -> Optional[torch.cuda.Stream]:
        """The tier copy stream (None on the CPU, where copies are
        synchronous)."""
        if self.device.type != "cuda":
            return None
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _to_host(self, views: dict) -> dict:
        """{seg: {field: device view}} -> host mirror of the same shape.
        On the card: pinned buffers filled on the copy stream after the
        work already queued on the compute stream."""
        st = self._copy_stream()
        if st is None:
            return {k: {f: v.clone() for f, v in fl.items()}
                    for k, fl in views.items()}
        st.wait_stream(torch.cuda.current_stream(self.device))
        out = {}
        with torch.cuda.stream(st):
            for k, fl in views.items():
                out[k] = {}
                for f, v in fl.items():
                    v.record_stream(st)     # the source may be freed early
                    h = torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                    h.copy_(v, non_blocking=True)
                    out[k][f] = h
        return out

    def _snapshot(self, views: dict) -> dict:
        """:meth:`_to_host` of device views that later compute-stream
        work may overwrite: on the card the compute stream waits for the
        copy, so nothing queued after it can write the source first."""
        mirror = self._to_host(views)
        st = self._copy_stream()
        if st is not None:
            torch.cuda.current_stream(self.device).wait_stream(st)
        return mirror

    def _from_host(self, pairs) -> None:
        """Copy each (device view, host tensor) pair in place.  On the
        card the copies wait for the work already queued (earlier readers
        of the destinations) and the compute stream waits for the copies
        (the step that reads them)."""
        st = self._copy_stream()
        if st is None:
            for dst, src in pairs:
                dst.copy_(src)
            return
        cur = torch.cuda.current_stream(self.device)
        st.wait_stream(cur)
        with torch.cuda.stream(st):
            for dst, src in pairs:
                dst.copy_(src, non_blocking=True)
        cur.wait_stream(st)

    def read_page_payload(self, cache: dict, slot: int) -> dict:
        """Spill, device half: payload slot ``slot`` of every SALS segment
        as a host mirror {seg: {field: (ls, ps, ·)}}."""
        return self._snapshot({
            k: {f: getattr(seg, f)[:, slot] for f in _PAGED_FIELDS
                if getattr(seg, f) is not None}
            for k, seg in self._latent_segs(cache).items()})

    def extract_page_payload_dense(self, one_cache: dict, page: int) -> dict:
        """Host mirror of logical page ``page`` of a finished prefill task's
        dense single-request cache: the cold half of a tiered admission
        (pages past the hot tier never touch the device payload pools)."""
        ps = self.scfg.page_size
        span = slice(page * ps, (page + 1) * ps)
        return self._to_host({
            k: {f: getattr(seg, f)[:, 0, span] for f in _PAGED_FIELDS
                if getattr(seg, f) is not None}
            for k, seg in self._latent_segs(one_cache).items()})

    def load_page(self, cache: dict, slot: int, payload: dict) -> dict:
        """Fetch, device half: install a host mirror into payload slot
        ``slot`` of every SALS segment (the pool fires the ``host_fetch``
        fault point before this, in ``begin_fetch``), through
        :meth:`_from_host`."""
        self._from_host([(getattr(cache[k], f)[:, slot], v)
                         for k, fl in payload.items() for f, v in fl.items()])
        return cache

    def clone_payload(self, mirror: dict) -> dict:
        """A host mirror's own copy (copy-on-write of a cold page); waits
        for the copies that may still be filling it."""
        st = self._copy_stream()
        if st is not None:
            st.synchronize()
        return self._to_host(mirror) if st is None else {
            k: {f: torch.empty(v.shape, dtype=v.dtype,
                               pin_memory=True).copy_(v)
                for f, v in fl.items()} for k, fl in mirror.items()}

    def copy_score_page(self, cache: dict, src: int, dst: int) -> dict:
        """Tiered copy-on-write, score half: duplicate physical page
        ``src`` into ``dst`` in the r* score pool (the payload half is
        :meth:`copy_page` on hot slots, or :meth:`clone_payload` of a cold
        source's mirror, which fire the ``cow_copy`` point first)."""
        for seg in self._latent_segs(cache).values():
            for name in ("k_score", "k_scale_score"):
                pool = getattr(seg, name)
                if pool is not None:
                    pool[:, dst] = pool[:, src]
        return cache

    def release_slot(self, cache: dict, slot: int) -> dict:
        """Metadata-only slot release: lengths (and the page-table row)
        reset; no payload is zeroed."""
        for seg in self._latent_segs(cache).values():
            seg.free_slot(slot)
        return cache

    def _slot_rows(self, cache: dict, slot: int) -> dict:
        """{seg: {field: view of batch row ``slot``}} of what a park
        carries: the latent segments' :data:`_PARK_FIELDS`, every tensor of
        a full-precision segment."""
        return {k: {f: getattr(seg, f)[:, slot] for f in _PARK_FIELDS}
                if isinstance(seg, LatentKVCache)
                else {f: arr[:, slot] for f, arr in seg.items()}
                for k, seg in cache.items()}

    def detach_slot(self, cache: dict, slot: int) -> dict:
        """Park: copy batch row ``slot``'s per-slot state to HOST memory
        (windows + lengths of the latent segments, whole slot rows of the
        full-precision ones) as {seg: {field: tensor}}.  Pure reads: the
        arena stays valid, and the copy survives any later write to it (on
        the card, pinned buffers filled on the copy stream, which the
        compute stream waits for).  Fires the ``park`` fault point BEFORE
        touching anything: an injected park fault leaves the victim fully
        resident."""
        maybe_fault("park")         # before any read: victim stays resident
        return self._snapshot(self._slot_rows(cache, slot))

    def attach_slot(self, cache: dict, slot: int, snap: dict) -> dict:
        """Resume: write a :meth:`detach_slot` snapshot back into batch
        row ``slot``, in place (no tensor of the arena is reallocated, so
        the step programs keep their keys).  Fires the ``resume`` fault
        point BEFORE the splice, so on an injected fault the snapshot and
        the arena are both still whole (the scheduler then releases the
        parked pages and retries the request from scratch)."""
        maybe_fault("resume")       # before the splice: snapshot stays whole
        rows = self._slot_rows(cache, slot)
        self._from_host([(rows[k][f], v) for k, fl in snap.items()
                         for f, v in fl.items()])
        return cache

    def with_page_tables(self, cache: dict, table: np.ndarray,
                         hot_table: Optional[np.ndarray] = None) -> dict:
        """Install the host page table ((B, max_pages) int32) — and, when
        tiered, the hot-slot table — into every SALS segment, broadcast
        over its layer axis."""
        for name, host in (("page_table", table), ("hot_table", hot_table)):
            if host is None:
                continue
            row = torch.as_tensor(np.asarray(host, np.int32),
                                  device=self.device)
            for seg in self._latent_segs(cache).values():
                if seg.paged:
                    dst = getattr(seg, name)
                    dst.copy_(row.expand_as(dst))
        return cache

    def sals_ring_state(self, cache: dict) -> dict:
        """Cloned (recent_k, recent_v) of every SALS segment: the
        page-boundary snapshot a prefix-cache entry stores."""
        return {k: (seg.recent_k.clone(), seg.recent_v.clone())
                for k, seg in self._latent_segs(cache).items()}

    @torch.inference_mode()
    def resume_seed(self, entry, n_shared_pages: int) -> Tuple[dict, dict]:
        """The prefill workspace (cache, scratch), set to resume a chunked
        prefill at page boundary ``n_shared_pages`` from a prefix-cache
        entry: the entry's final (append-only) state copied in, the ring
        restored from its snapshot at the boundary.  The entry keeps its
        own tensors: the resumed task writes the workspace in place, and
        the entry must outlive it."""
        cache, scratch = self._reset_workspace((entry.cache, entry.scratch))
        for name, (rk, rv) in entry.boundary_rings[n_shared_pages].items():
            cache[name].recent_k.copy_(rk)
            cache[name].recent_v.copy_(rv)
        return cache, scratch

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
        self.reset_sampler()
        t0 = time.perf_counter()
        pos0 = np.asarray(lens, np.int32)
        logits, cache = tf.prefill(
            self.params, self.projectors, self.cfg, self.sals,
            {"tokens": torch.as_tensor(toks, device=dev)},
            self.scfg.max_seq_len, n_groups=self.n_groups,
            lengths=torch.as_tensor(pos0, device=dev))
        out = np.zeros((b, mnt), np.int32)
        done = np.zeros((b,), bool)
        n_out = np.zeros((b,), np.int32)
        next_tok = self._sample(logits)
        t_first = None
        cap0 = self._decode.capture_s
        for t in range(mnt):
            # waits for the device: the host read that ends every step
            out[:, t] = next_tok.cpu().numpy()
            if t_first is None:
                t_first = time.perf_counter()
            n_out[~done] = t + 1
            if eos_id is not None:
                done |= out[:, t] == eos_id
                if done.all():
                    break
            if t == mnt - 1:
                break
            logits, cache = self.decode(next_tok, cache, pos0 + t)
            next_tok = self._sample(logits)
        t_end = time.perf_counter()
        capture_s = self._decode.capture_s - cap0
        self.last_timing = {"prefill_s": t_first - t0,
                            "decode_s": t_end - t_first - capture_s,
                            "decode_steps": int(n_out.max()) - 1,
                            "capture_s": capture_s}
        return [GenerationResult(out[i, :n_out[i]], lens[i], int(n_out[i]))
                for i in range(b)]

    @torch.inference_mode()
    def generate_speculative(self, prompts: List[np.ndarray],
                             max_new_tokens: Optional[int] = None,
                             eos_id: Optional[int] = None
                             ) -> List[GenerationResult]:
        """Greedy generation through the speculative verify window.

        Each round drafts ``spec_window`` − 1 tokens per row (prompt
        lookup, :class:`~repro_torch.serve.draft.NgramDrafter`), runs ONE
        windowed forward over [pending token + drafts] and commits the
        longest prefix whose greedy continuations match the drafts.  Window
        slot 0 is the already-emitted pending token, so every round makes
        progress.  Each query of the window attends what its sequential
        step would, so the stream is token-exact with :meth:`generate`
        wherever N_c covers every selectable position.  Rows stop at their
        own EOS; ``spec_stats`` afterwards holds the round / draft /
        acceptance counters."""
        q = self.scfg.spec_window
        if q < 2:
            raise ValueError("generate_speculative needs spec_window >= 2 "
                             f"(got {q}); use generate() for sequential")
        if self.scfg.temperature > 0:
            raise ValueError("speculative verify is greedy: argmax "
                             "continuations are compared token-exactly "
                             "(temperature must be 0)")
        mnt = max_new_tokens or self.scfg.max_new_tokens
        b = len(prompts)
        lens = [len(p) for p in prompts]
        max_len = max(lens)
        if max_len + mnt + q - 1 > self.scfg.max_seq_len:
            # the last window may read (never commit) q - 1 positions past
            # the final token
            raise ValueError(f"prompt {max_len} + new {mnt} + window {q}-1 "
                             f"exceeds max_seq {self.scfg.max_seq_len}")
        toks = np.full((b, max_len), self.scfg.pad_id, np.int32)
        for i, p in enumerate(prompts):
            toks[i, :lens[i]] = p
        dev = self.device
        t0 = time.perf_counter()
        logits, cache = tf.prefill(
            self.params, self.projectors, self.cfg, self.sals,
            {"tokens": torch.as_tensor(toks, device=dev)},
            self.scfg.max_seq_len, n_groups=self.n_groups,
            lengths=torch.as_tensor(lens, dtype=torch.int32, device=dev))
        out = np.zeros((b, mnt), np.int32)
        done = np.zeros((b,), bool)
        n_out = np.ones((b,), np.int32)
        pending = self._sample(logits).cpu().numpy()
        t_first = time.perf_counter()
        out[:, 0] = pending
        if eos_id is not None:
            done |= pending == eos_id
        done |= n_out >= mnt
        drafters = [NgramDrafter(list(map(int, prompts[i]))
                                 + [int(pending[i])]) for i in range(b)]
        graphs = (self._decode_window, self._commit_window)
        cap0 = sum(g.capture_s for g in graphs)
        pos = np.asarray(lens, np.int32)                 # window bases
        self.spec_stats = {"rounds": 0, "proposed": 0, "accepted_drafts": 0,
                           "committed": 0}
        while not done.all():
            wt = np.zeros((b, q), np.int32)
            wt[:, 0] = pending
            for i in range(b):
                if not done[i]:
                    wt[i, 1:] = drafters[i].propose(q - 1)
            win_logits, aux = self.decode_window(wt, cache, pos)
            preds = torch.argmax(win_logits, dim=-1).cpu().numpy()  # (B, Q)
            n_matched = np.cumprod(wt[:, 1:] == preds[:, :-1],
                                   axis=1).sum(axis=1)
            n_emit = np.where(done, 0, np.minimum(n_matched + 1, mnt - n_out))
            rows: List[List[int]] = []
            for i in range(b):
                row = [int(t) for t in preds[i, :n_emit[i]]]
                if eos_id is not None and eos_id in row:
                    row = row[:row.index(eos_id) + 1]    # stop at own EOS
                rows.append(row)
            # slot t's input is right for t < len(row); the last emitted
            # token becomes the next window's slot 0
            cache = self.commit_window(cache, aux, pos,
                                       [len(r) for r in rows])
            self.spec_stats["rounds"] += 1
            for i, row in enumerate(rows):
                if not row:
                    continue
                self.spec_stats["proposed"] += q - 1
                self.spec_stats["accepted_drafts"] += int(n_matched[i])
                self.spec_stats["committed"] += len(row)
                out[i, n_out[i]:n_out[i] + len(row)] = row
                n_out[i] += len(row)
                pending[i] = row[-1]
                pos[i] += len(row)
                drafters[i].extend(row)
                if (eos_id is not None and row[-1] == eos_id) \
                        or n_out[i] >= mnt:
                    done[i] = True
        t_end = time.perf_counter()
        capture_s = sum(g.capture_s for g in graphs) - cap0
        self.last_timing = {"prefill_s": t_first - t0,
                            "decode_s": t_end - t_first - capture_s,
                            "rounds": self.spec_stats["rounds"],
                            "capture_s": capture_s}
        return [GenerationResult(out[i, :n_out[i]], lens[i], int(n_out[i]))
                for i in range(b)]

    @torch.inference_mode()
    def decode_throughput(self, batch_size: int, context_len: int,
                          n_steps: int = 32) -> float:
        """Tokens/s of the steady-state decode loop (a benchmark helper):
        ``batch_size`` rows of ``context_len`` tokens, prefilled at once,
        then ``n_steps`` decode steps through the captured decode program.

        Timed by the installed :class:`~repro_torch.obs.trace.SpanTracer`
        when telemetry is on, a private one otherwise, so this figure and
        live serving share one clock and one span code path.  The span
        opens after a first (capturing) step and a synchronization, and
        closes after a synchronization, so it holds the device time of the
        ``n_steps`` replays.  With a registry installed the result is also
        the ``engine_decode_tokens_per_s`` gauge."""
        tracer = obs_trace.active() or obs_trace.SpanTracer()
        dev = self.device
        toks = torch.ones((batch_size, context_len), dtype=torch.int32,
                          device=dev)
        lengths = torch.full((batch_size,), context_len, dtype=torch.int32,
                             device=dev)
        logits, cache = tf.prefill(self.params, self.projectors, self.cfg,
                                   self.sals, {"tokens": toks},
                                   self.scfg.max_seq_len,
                                   n_groups=self.n_groups, lengths=lengths)
        next_tok = torch.argmax(logits, dim=-1).to(torch.int32)
        pos0 = np.full((batch_size,), context_len, np.int32)
        self.decode(next_tok, cache, pos0)     # the capture (on the card)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        sid = tracer.begin("decode_throughput", "engine", batch=batch_size,
                           context=context_len, steps=n_steps)
        for t in range(n_steps):
            self.decode(next_tok, cache, pos0 + 1 + t)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt = tracer.end(sid)
        tok_s = batch_size * n_steps / dt
        reg = obs_metrics.active()
        if reg is not None:
            reg.gauge("engine_decode_tokens_per_s",
                      "steady-state decode throughput (last probe)",
                      labelnames=("batch", "context")).set(
                tok_s, batch=batch_size, context=context_len)
        return tok_s
