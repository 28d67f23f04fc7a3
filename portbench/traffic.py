"""The general traffic generator: every mix is a data file of parameters
(``portbench/traffic/<mix>.json``) that this module turns into inputs
from ``--seed``.

Two kinds, named by the file's ``driver``:

* ``session``: a fixed batch of rows, each a distinct prompt of
  ``prompt_len`` uniform token ids, decoded together.
* ``open_loop``: requests sent on a schedule whatever the server does.
  Prompt lengths are lognormal (``median``, ``sigma``) clipped to
  [``min``, ``max``]; a share of the requests begins with one of a few
  shared system prompts; output lengths are uniform on [``min``,
  ``max``], cut so that prompt and output fit ``max_seq_len``;
  inter-arrival gaps are exponential at ``rate_per_s``.

So that the seed changes neither the amount nor the shape of the work,
every seed gets the same prompt lengths, output lengths, shared flags
and gaps (quantiles of the stated distributions) in the same order (one
fixed shuffle, by the mix's ``shape_seed``, else ``SHAPE_SEED``); the
seed draws the token ids and which system prompt a shared request begins
with.  Near the knee the order of arrivals alone moves the tail of the
time to first token by a third (seeds that shuffled it read 1.6-2.6 s
at p90 where two runs of one seed agreed within a tenth), so one window
of a mix is one realization of its arrival process; another
``shape_seed`` in another mix file is another.  The ``n`` requests of a
window of T seconds are due in [0, T), the gaps scaled to sum to T.
"""
from __future__ import annotations

import dataclasses
import json
import math
import statistics
from pathlib import Path
from typing import List

import numpy as np

ROOT = Path(__file__).resolve().parent
_STREAMS = {"traffic": 1, "calibration": 2, "check": 3, "warmup": 4,
            "background": 5}
SHAPE_SEED = 20251018        # the one shuffle of the sizes and gaps


def load_mix(name: str, root: Path = ROOT) -> dict:
    """The mix file ``traffic/<name>.json``, found by name."""
    with open(root / "traffic" / f"{name}.json") as f:
        return json.load(f)


def rng(seed: int, stream: str) -> np.random.Generator:
    """An independent stream of the run's seed for each use."""
    return np.random.default_rng([int(seed) % (1 << 63), _STREAMS[stream]])


def tokens(r: np.random.Generator, shape, vocab: int) -> np.ndarray:
    """Uniform ids in [1, vocab) (0 is the pad id)."""
    return r.integers(1, vocab, size=shape, dtype=np.int64).astype(np.int32)


def calibration_tokens(cal: dict, vocab: int, seed: int) -> np.ndarray:
    """(rows, seq_len) calibration sequences of the configuration."""
    return tokens(rng(seed, "calibration"), (cal["rows"], cal["seq_len"]),
                  vocab)


@dataclasses.dataclass
class SessionInputs:
    prompts: np.ndarray          # (rows, prompt_len) int32
    check_rows: List[int]        # the rows whose tokens are checked


def session_inputs(mix: dict, vocab: int, seed: int) -> SessionInputs:
    rows = mix["rows"]
    prompts = tokens(rng(seed, "traffic"), (rows, mix["prompt_len"]), vocab)
    pick = rng(seed, "check").permutation(rows)[:mix["check_rows"]]
    return SessionInputs(prompts, sorted(int(i) for i in pick))


@dataclasses.dataclass
class Arrival:
    due_s: float                 # seconds after the window opens
    prompt: np.ndarray           # int32
    max_new_tokens: int
    counted: bool                # due inside the window


def _quantiles(n: int) -> np.ndarray:
    return (np.arange(n) + 0.5) / n


def _sizes(mix: dict, n: int, r: np.random.Generator):
    """(prompt lengths, output lengths, shared flags, gaps) for n
    requests, in the order ``r`` shuffles them."""
    p, o = mix["prompt"], mix["output"]
    nd = statistics.NormalDist()
    z = np.array([nd.inv_cdf(q) for q in _quantiles(n)])
    plen = np.clip(np.round(p["median"] * np.exp(p["sigma"] * z)),
                   p["min"], p["max"]).astype(int)
    olen = np.round(o["min"] + (o["max"] - o["min"]) * _quantiles(n)) \
        .astype(int)
    # shared flags spread evenly over the lengths, and kept with them
    k = round(mix["shared"]["share"] * n)
    shared = np.floor((np.arange(n) + 1) * k / n) \
        > np.floor(np.arange(n) * k / n)
    gaps = -np.log1p(-_quantiles(n))
    order = r.permutation(n)
    return (plen[order], r.permutation(olen), shared[order],
            r.permutation(gaps))


def _requests(mix: dict, n: int, shape: np.random.Generator,
              r: np.random.Generator, vocab: int, system: np.ndarray,
              due: np.ndarray, counted: bool) -> List[Arrival]:
    plen, olen, shared, _ = _sizes(mix, n, shape)
    sh = mix["shared"]
    out = []
    for i in range(n):
        if shared[i]:
            user = tokens(r, max(plen[i] - sh["prefix_len"],
                                 sh["min_suffix"]), vocab)
            prompt = np.concatenate([system[r.integers(len(system))], user])
        else:
            prompt = tokens(r, plen[i], vocab)
        new = int(min(olen[i], mix["max_seq_len"] - len(prompt)))
        out.append(Arrival(float(due[i]), prompt, new, counted))
    return out


def open_loop(mix: dict, vocab: int, seed: int, seconds: float,
              rate: float = None) -> List[Arrival]:
    """The window's requests (``counted``), due in [0, seconds), then as
    many again at the same rate after it (load that keeps the server
    busy until the window's last request is served; not counted)."""
    rate = mix["rate_per_s"] if rate is None else rate
    r = rng(seed, "traffic")
    shape_seed = mix.get("shape_seed", SHAPE_SEED)
    shape = np.random.default_rng([shape_seed, _STREAMS["traffic"]])
    sh = mix["shared"]
    system = tokens(r, (sh["n_prefixes"], sh["prefix_len"]), vocab)
    n = max(1, round(rate * seconds))
    gaps = _sizes(mix, n, shape)[3]
    due = np.concatenate([[0.0], np.cumsum(gaps)[:-1]]) \
        * seconds / gaps.sum()
    window = _requests(mix, n, shape, r, vocab, system, due, True)
    bshape = np.random.default_rng([shape_seed, _STREAMS["background"]])
    bgaps = bshape.permutation(-np.log1p(-_quantiles(n))) / rate
    bdue = seconds + np.cumsum(bgaps)
    return window + _requests(mix, n, bshape, rng(seed, "background"),
                              vocab, system, bdue, False)


def percentile(values, p: float) -> float:
    """Nearest-rank percentile: the smallest value with at least p% of
    the values at or below it."""
    v = sorted(values)
    if not v:
        return math.nan
    return float(v[max(0, math.ceil(p / 100.0 * len(v)) - 1)])
