"""Measured-vs-modeled traffic accountant: the port's byte ledger as a
runtime invariant (port of ``repro/obs/traffic.py``).

:class:`TrafficAccountant` counts, every decode step, the bytes the port's
kernels move, derived from the shapes and dtypes of the live cache arena
(the tensors the kernels stream: ``k_lat`` / ``k_score`` give ``b_lat``,
the quantized value record gives ``v_tok``, the sink/recent buffers give
the window, the page table or the arena's rows give the score scratch,
the resident projector gives ``U_r``; every width is a
``torch.dtype.itemsize``), and reconciles them term by term against the
port's own model, :mod:`repro_torch.obs.ledger` (whose docstring states
each term and how the score term differs from the reference's).
Divergence beyond ``tol`` raises a typed :class:`TrafficDriftError`:
change the cache layout without updating the ledger (or the reverse) and
serving fails loudly.

Terms per decode step per SALS layer and row: ``score_bytes``,
``selected_bytes``, ``window_bytes``, ``u_bytes``; per verify window also
``spec_window_bytes``; per host <-> device page transfer ``fetch_bytes`` /
``spill_bytes``, measured as the ``numel() * element_size()`` of exactly
the host mirror tensors the copy moves.

Scope: SALS layers only (full-attention layers are outside the ledger).
Every input is host state (shapes, dtypes, the scheduler's host-side
positions), so observing a step adds no device synchronization.  Install
contract matches ``serve/faults.py``.
"""
from __future__ import annotations

from contextlib import contextmanager
from typing import Dict, Optional

import torch

from repro_torch.obs import ledger

__all__ = ["TrafficAccountant", "TrafficDriftError",
           "active", "install", "installed", "uninstall"]

_DECODE_TERMS = ("score_bytes", "selected_bytes", "window_bytes", "u_bytes")


class TrafficDriftError(RuntimeError):
    """Measured bytes diverged from the modeled ledger beyond tolerance."""

    def __init__(self, term: str, measured: float, modeled: float,
                 tol: float, where: str):
        self.term, self.measured, self.modeled = term, measured, modeled
        self.tol, self.where = tol, where
        super().__init__(
            f"traffic drift[{where}] term {term!r}: measured {measured:.1f}"
            f" vs modeled {modeled:.1f} B (tol {tol:.2%}) — the cache "
            "layout and repro_torch/obs/ledger.py disagree")


def _rel_close(a: float, b: float, tol: float) -> bool:
    return abs(a - b) <= tol * max(abs(a), abs(b), 1.0)


class TrafficAccountant:
    """Counts actual bytes per decode step and reconciles vs the ledger.

    Construct with the engine's model config + SALS config; byte widths
    are captured lazily from the first live cache arena seen (so they are
    the engine's real dtypes, not assumptions).  The scheduler calls
    :meth:`observe_decode` once per committed decode step / verify window
    and :meth:`observe_transfer` per tier fetch / spill; both reconcile
    immediately and accumulate onto the attached registry when present.
    """

    def __init__(self, cfg, sals, tol: float = 0.01, registry=None,
                 strict: bool = True):
        self.cfg = cfg
        self.sals = sals
        self.tol = tol
        self.strict = strict
        self.registry = registry
        self.widths: Optional[dict] = None
        self.steps = 0
        self.reconciled = 0
        self.drifts = 0
        self.measured_totals: Dict[str, float] = {
            t: 0.0 for t in _DECODE_TERMS}
        self.measured_totals.update(spec_window_bytes=0.0,
                                    fetch_bytes=0.0, spill_bytes=0.0)
        self.modeled_totals = dict(self.measured_totals)
        self._bytes_ctr = None
        if registry is not None:
            self._bytes_ctr = registry.counter(
                "traffic_bytes_total",
                "actual HBM/PCIe bytes moved per ledger term",
                labelnames=("term", "source"))
        # the ledger is pure in (cfg, sals, s, rows): memoized per s, so
        # the hot path pays dict arithmetic.  The MEASURED side is never
        # cached: it re-reads ``widths`` every step, so a layout change (or
        # a test's tamper) surfaces.
        self._model_rows: Dict[int, dict] = {}
        self._rows_model: Optional[int] = None
        self._page_size: Optional[int] = None

    # -- width capture -----------------------------------------------------

    def _capture(self, engine, cache):
        segs = engine._latent_segs(cache)
        if not segs:
            # every layer is a skip layer: the ledger is empty and there is
            # nothing to reconcile (scope: SALS layers only)
            self.widths = {}
            return self.widths
        seg = next(iter(segs.values()))
        n_layers = sum(s.k_lat.shape[0] for s in segs.values())

        def nbytes(t):            # bytes per token of a per-token field
            return t.shape[-1] * t.dtype.itemsize

        v_tok = nbytes(seg.v_q) + nbytes(seg.v_scale) + nbytes(seg.v_zero)
        kvd = seg.sink_k.shape[-1] * seg.sink_k.shape[-2]
        r_star = (seg.k_score.shape[-1] if seg.k_score is not None
                  else self.sals.score_rank(kvd))
        if seg.paged:             # the scratch spans the page table
            rows = seg.page_table.shape[-1] * seg.k_lat.shape[-2]
        else:
            rows = seg.k_lat.shape[-2]
        u = engine.projectors["u"]
        self.widths = {
            "n_layers": n_layers,
            "r": seg.k_lat.shape[-1],
            "r_star": r_star,
            "lat_b": seg.k_lat.dtype.itemsize,
            "scale_b": (seg.k_scale.dtype.itemsize
                        if seg.k_scale is not None else 0),
            "v_tok": v_tok,
            "kvd": kvd,
            "win_tokens": seg.sink_k.shape[-3] + seg.recent_k.shape[-3],
            "win_b": seg.sink_k.dtype.itemsize,
            "u_bytes": u.shape[-2] * u.shape[-1] * u.dtype.itemsize,
            # the score scratch (f32) and the selection's idx / valid
            "rows": rows,
            "scratch_b": torch.float32.itemsize,
            "sel_out_b": torch.int32.itemsize + torch.bool.itemsize,
            "n_c": self.sals.n_critical,
        }
        scfg = engine.scfg
        self._rows_model = ledger.score_rows(
            scfg.max_seq_len, scfg.page_size if engine.paged else 0)
        return self.widths

    # -- measured side -----------------------------------------------------

    def _measured_row(self, s: int) -> dict:
        """Actual kernel bytes for ONE row at context length ``s``, per
        SALS layer: every width read off the live arena."""
        w = self.widths
        nc = min(s, w["n_c"])
        return {
            "score_bytes": s * (w["r_star"] * w["lat_b"] + w["scale_b"])
            + 2 * w["rows"] * w["scratch_b"] + w["n_c"] * w["sel_out_b"],
            "selected_bytes": nc * (w["r"] * w["lat_b"] + w["scale_b"]
                                    + w["v_tok"])
            + nc * ledger.SELECTED_IDX_BYTES,
            "window_bytes": w["win_tokens"] * 2 * w["kvd"] * w["win_b"],
            "u_bytes": w["u_bytes"],
        }

    # -- observation + reconciliation -------------------------------------

    def _drift(self, term, measured, modeled, where):
        self.drifts += 1
        if self.registry is not None:
            self.registry.counter(
                "traffic_drift_total", "reconciliation failures",
                labelnames=("term",)).inc(term=term)
        if self.strict:
            raise TrafficDriftError(term, measured, modeled, self.tol,
                                    where)

    def _count(self, term: str, measured: float, modeled: float) -> None:
        self.measured_totals[term] += measured
        self.modeled_totals[term] += modeled
        if self._bytes_ctr is not None:
            self._bytes_ctr.inc(measured, term=term, source="measured")
            self._bytes_ctr.inc(modeled, term=term, source="modeled")

    def observe_decode(self, engine, cache, positions, *, q_len: int = 1):
        """Account one decode step (or one verify window when ``q_len >
        1``) for live rows at context lengths ``positions`` (host ints).
        Reconciles each term against :func:`ledger.decode_stage_bytes`
        (and the window K/V term, :func:`ledger.spec_window_bytes`)."""
        if not positions:
            return
        if self.widths is None:
            self._capture(engine, cache)
        if not self.widths:       # zero SALS layers: empty ledger scope
            return
        nl = self.widths["n_layers"]
        meas = {t: 0.0 for t in _DECODE_TERMS}
        model = {t: 0.0 for t in _DECODE_TERMS}
        for s in positions:
            s = int(s)
            m = self._measured_row(s)
            ref = self._model_rows.get(s)
            if ref is None:
                ref = self._model_rows[s] = ledger.decode_stage_bytes(
                    self.cfg, self.sals, s, self._rows_model)
            for t in _DECODE_TERMS:
                meas[t] += m[t] * nl
                model[t] += ref[t] * nl
        where = f"decode step {self.steps}"
        for t in _DECODE_TERMS:
            if not _rel_close(meas[t], model[t], self.tol):
                self._drift(t, meas[t], model[t], where)
            self._count(t, meas[t], model[t])
        if q_len > 1:
            # verify window: the only EXTRA bytes are its in-flight K/V
            w = self.widths
            meas_win = len(positions) * q_len * 2 * w["kvd"] * w["win_b"] \
                * nl
            model_win = len(positions) * nl * ledger.spec_window_bytes(
                self.cfg, q_len)
            if not _rel_close(meas_win, model_win, self.tol):
                self._drift("spec_window_bytes", meas_win, model_win,
                            where)
            self._count("spec_window_bytes", meas_win, model_win)
        self.steps += 1
        self.reconciled += 1

    def observe_transfer(self, kind: str, pages: int, nbytes: int):
        """Account one host <-> device transfer batch: ``nbytes`` is the
        SUM of ``numel() * element_size()`` over the host mirror tensors
        moved (kind: "fetch" | "spill"); the modeled side is
        :func:`ledger.tier_page_bytes` per page."""
        if pages <= 0:
            return
        if self._page_size is None:
            raise RuntimeError("observe_transfer before bind_page_size")
        key = f"{kind}_bytes"
        if key not in self.measured_totals:
            raise ValueError(f"unknown transfer kind {kind!r}")
        modeled = pages * ledger.tier_page_bytes(self.cfg, self.sals,
                                                 self._page_size)
        if not _rel_close(float(nbytes), modeled, self.tol):
            self._drift(key, float(nbytes), modeled,
                        f"{kind} of {pages} page(s)")
        self._count(key, float(nbytes), modeled)

    def bind_page_size(self, page_size: int):
        self._page_size = page_size

    def report(self) -> dict:
        return {"steps": self.steps, "reconciled": self.reconciled,
                "drifts": self.drifts,
                "measured": dict(self.measured_totals),
                "modeled": dict(self.modeled_totals)}


# -- install / uninstall: the serve/faults.py contract ---------------------

_ACTIVE: Optional[TrafficAccountant] = None


def active() -> Optional[TrafficAccountant]:
    return _ACTIVE


def install(acct: Optional[TrafficAccountant]):
    global _ACTIVE
    _ACTIVE = acct


def uninstall():
    install(None)


@contextmanager
def installed(acct: TrafficAccountant):
    prev = _ACTIVE
    install(acct)
    try:
        yield acct
    finally:
        install(prev)
