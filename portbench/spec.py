"""A configuration file read into plain numbers.

``portbench/configs/<name>.json`` holds a model's published sizes under
their ``config.json`` names, the SALS settings it is served with, how the
benchmark draws its weights, and which plain reference checks it.  This
module turns that file into a :class:`ModelSpec` that the weight maker,
the reference and the yardstick share; the port gets the same numbers
through ``portbench/program.py``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Tuple

import torch

ROOT = Path(__file__).resolve().parent


def _round_to(x: int, m: int) -> int:
    return max(m, ((x + m - 1) // m) * m)


@dataclasses.dataclass(frozen=True)
class SalsSpec:
    rank_ratio: float
    score_ratio: float
    n_critical: int
    n_sink: int
    n_recent: int
    v_bits: int
    v_group: int
    k_latent_dtype: str
    skip_layers_front: int
    skip_layers_back: int

    def rank(self, kv_dim: int) -> int:
        """r: the latent width, rank_ratio of kv_dim on a multiple of 8."""
        r = int(round(self.rank_ratio * kv_dim))
        return max(8, min(kv_dim, _round_to(r, 8)))

    def score_rank(self, kv_dim: int) -> int:
        """r*: the scored latent columns, score_ratio of r on a multiple
        of 8."""
        return max(8, _round_to(int(round(self.score_ratio
                                          * self.rank(kv_dim))), 8))


@dataclasses.dataclass(frozen=True)
class ModelSpec:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    rope_theta: float
    norm_eps: float
    dtype: str
    sals: SalsSpec
    key_sigma: Tuple[float, float, float]
    query_gain: float
    reference: str

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def group(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def r(self) -> int:
        return self.sals.rank(self.kv_dim)

    @property
    def r_star(self) -> int:
        return self.sals.score_rank(self.kv_dim)

    @property
    def torch_dtype(self) -> torch.dtype:
        return getattr(torch, self.dtype)

    def sals_layer(self, l: int) -> bool:
        """True where layer ``l`` attends through the latent cache; the
        first ``skip_layers_front`` and last ``skip_layers_back`` keep a
        full-precision cache."""
        s = self.sals
        return s.skip_layers_front <= l < self.n_layers - s.skip_layers_back

    @property
    def n_sals_layers(self) -> int:
        return sum(self.sals_layer(l) for l in range(self.n_layers))


def spec_from_dict(c: dict) -> ModelSpec:
    if c.get("hidden_act", "silu") != "silu":
        raise ValueError(f"{c['name']}: only the gated SiLU MLP is served")
    if c.get("tie_word_embeddings") is not False:
        raise ValueError(f"{c['name']}: the dense reference unembeds "
                         "through a separate lm_head")
    return ModelSpec(
        name=c["name"], n_layers=c["num_hidden_layers"],
        d_model=c["hidden_size"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        d_ff=c["intermediate_size"], vocab_size=c["vocab_size"],
        rope_theta=float(c["rope_theta"]), norm_eps=float(c["rms_norm_eps"]),
        dtype=c["torch_dtype"], sals=SalsSpec(**c["sals"]),
        key_sigma=tuple(c["weights"]["key_sigma"]),
        query_gain=float(c["weights"]["query_gain"]),
        reference=c["reference"])


def load_config(name: str, root: Path = ROOT) -> dict:
    """The configuration file ``configs/<name>.json``, found by name."""
    path = root / "configs" / f"{name}.json"
    with open(path) as f:
        c = json.load(f)
    if c.get("name") != name:
        raise ValueError(f"{path} names itself {c.get('name')!r}")
    return c
