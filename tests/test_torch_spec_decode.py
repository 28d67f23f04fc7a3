"""Port parity for slice 3, speculative decode through the verify window.

Kernel twins: the port's windowed recon twins against the JAX reference on
the same seeded numpy inputs — its ``xla`` oracles and, dense only, its
``sparse_recon_attention_window_pallas`` in interpret mode (the paged
Pallas kernels do not trace on this jax) — allclose(rtol = atol = 1e-5);
and inside the port, bit for bit: a one-query window equals the
single-token twin, query t of a window equals the single-token twin at
q_pos + t on its gated set, and paged equals dense.  The ``requires_cuda``
cases hold the same invariants on the CUDA kernels.

Engine and scheduler: reduced f32 paper-llama2-7b (MHA) and yi-9b (GQA)
with the reference's saturated SALS settings (``tests/test_spec_decode.py``:
N_c covers every selectable position, so one selection per window is
exact).  ``generate_speculative`` is token-exact with the JAX engine's and
with the port's own ``generate`` for Q in {2, 4, 8} and for adversarial
drafters; a round whose drafts are all rejected commits exactly what one
sequential step commits (bitwise: the window's forward writes no committed
byte, the commit writes slot 0 as the sequential write path does and
nothing else; at Q = 1 forward and commit equal a decode step); the
scheduler's speculative branch is token-exact with the JAX scheduler's
(paged with prefix sharing, and dense), with equal ``spec_*`` counters and
contiguous streams; fault points retry or confine as in sequential
decode."""
import dataclasses
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.config import ServeConfig as JServe
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.kernels import ops as jops
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import RequestScheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.core.latent_cache import LatentKVCache
from repro_torch.core.sparse_attention import sals_window_attend
from repro_torch.kernels import ops, ref
from repro_torch.kernels import sparse_recon_attention as sra
from repro_torch.models import transformer as ttf
from repro_torch.serve import Request, RequestScheduler, ServeEngine
from repro_torch.serve import faults
from repro_torch.serve.draft import NgramDrafter

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)


def _t(a, dtype=None):
    """numpy -> torch, via f32 for bf16 (exact)."""
    if dtype == torch.bfloat16:
        return torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)
    return torch.from_numpy(np.array(a))


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs twin)")
    return torch.device("cuda")


# ---------------------------------------------------------------------------
# kernel twins
# ---------------------------------------------------------------------------

def _win_inputs(seed, b, ql, h, n_kv, dh, s, r, n_c, lat_dtype, v_bits):
    """Seeded numpy operands of a verify window: sorted valid indices first
    (one row half full, one empty), ragged window bases."""
    rng = np.random.default_rng(seed)
    kvd = n_kv * dh
    q = rng.standard_normal((b, ql, h, dh)).astype(np.float32)
    lat = rng.standard_normal((b, s, r)).astype(np.float32)
    scale = None
    if lat_dtype == "int8":
        lat = np.clip(np.round(lat * 30), -127, 127).astype(np.int8)
        scale = (rng.integers(1, 5, (b, s)) / 64).astype(np.float32)
    code_w = kvd if v_bits == 8 else kvd // 2
    if v_bits == 8:
        vq = rng.integers(-128, 128, (b, s, code_w)).astype(np.int8)
    else:
        vq = rng.integers(0, 256, (b, s, code_w)).astype(np.uint8)
    g = kvd // 16
    vs = (rng.random((b, s, g)) * 0.05).astype(np.float32)
    vz = rng.standard_normal((b, s, g)).astype(np.float32)
    u = (rng.standard_normal((kvd, r)) * r ** -0.5).astype(np.float32)
    q_pos = np.array([s - ql, s - ql - 5, s - ql - 20][:b], np.int32)
    idx = np.zeros((b, n_c), np.int32)
    valid = np.zeros((b, n_c), bool)
    for i, n in enumerate([n_c, n_c // 2, 0][:b]):
        sel = np.sort(rng.choice(q_pos[i] + ql, n, replace=False))
        idx[i, :n] = sel
        idx[i, n:] = rng.integers(0, s, n_c - n)
        valid[i, :n] = True
    return q, lat, scale, vq, vs, vz, u, idx, valid, q_pos


_LAT = {"bf16": (jnp.bfloat16, torch.bfloat16), "int8": (jnp.int8,
                                                         torch.int8),
        "f32": (jnp.float32, torch.float32)}


def _torch_args(inputs, lat_dtype):
    q, lat, scale, vq, vs, vz, u, idx, valid, q_pos = inputs
    return [_t(q), _t(lat, _LAT[lat_dtype][1]),
            None if scale is None else _t(scale, torch.bfloat16), _t(vq),
            _t(vs, torch.bfloat16), _t(vz, torch.bfloat16),
            _t(u, torch.bfloat16), _t(idx), _t(valid), _t(q_pos)]


def _jax_args(inputs, lat_dtype):
    q, lat, scale, vq, vs, vz, u, idx, valid, q_pos = inputs
    return [jnp.asarray(q), jnp.asarray(lat, _LAT[lat_dtype][0]),
            None if scale is None else jnp.asarray(scale, jnp.bfloat16),
            jnp.asarray(vq), jnp.asarray(vs, jnp.bfloat16),
            jnp.asarray(vz, jnp.bfloat16), jnp.asarray(u, jnp.bfloat16),
            jnp.asarray(idx), jnp.asarray(valid), jnp.asarray(q_pos)]


WINDOW_CASES = {
    # (ql, h, n_kv, dh, lat_dtype, v_bits, softcap, n_recent, with_base)
    "mha-q4-gate": (4, 4, 4, 16, "bf16", 8, 0.0, 8, False),
    "gqa-q8-int8-base": (8, 8, 2, 16, "int8", 8, 0.0, 8, True),
    "gqa-q2-int4-softcap": (2, 8, 2, 16, "bf16", 4, 20.0, 8, False),
    "q1-gate": (1, 4, 2, 16, "int8", 8, 0.0, 6, False),
    "q4-no-gate": (4, 4, 4, 16, "bf16", 8, 0.0, 0, True),
}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("case", sorted(WINDOW_CASES))
def test_window_twin_matches_reference(backend, case):
    ql, h, n_kv, dh, lat_dtype, v_bits, softcap, n_recent, with_base = \
        WINDOW_CASES[case]
    inputs = _win_inputs(21, 3, ql, h, n_kv, dh, 72, 16, 24, lat_dtype,
                         v_bits)
    base = np.array([0, 40, 3], np.int32) if with_base else None
    kw = dict(n_kv=n_kv, n_recent=n_recent, v_bits=v_bits, v_group=16,
              theta=10_000.0, softcap=softcap)
    j = jops.sparse_recon_attention_window(
        *_jax_args(inputs, lat_dtype),
        pos_base=None if base is None else jnp.asarray(base),
        backend=backend, **kw)
    t = ops.sparse_recon_attention_window(
        *_torch_args(inputs, lat_dtype),
        pos_base=None if base is None else _t(base), **kw)
    for a, b_ in zip(j, t):
        np.testing.assert_allclose(np.asarray(a), b_.numpy(), **TOL)
    # the empty row: every query fully masked
    assert (t[0][2] == ref.NEG_INF).all() and (t[1][2] == 0).all() \
        and (t[2][2] == 0).all()


def _paged(inputs, ps, seed):
    """Scatter the dense per-token operands into a shuffled page pool with
    spare pages; each row's last page is unmapped (its table entry names
    an arbitrary pool page)."""
    rng = np.random.default_rng(seed)
    q, lat, scale, vq, vs, vz, u, idx, valid, q_pos = inputs
    b, s = lat.shape[:2]
    mp = s // ps
    n_pages = b * mp + 3
    perm = rng.permutation(n_pages)
    table = rng.integers(0, n_pages, (b, mp)).astype(np.int32)

    def pool(a):
        out = np.zeros((n_pages, ps) + a.shape[2:], a.dtype)
        for i in range(b):
            for p in range(mp - 1):          # the last page stays unmapped
                out[perm[i * mp + p]] = a[i, p * ps:(p + 1) * ps]
        return out

    for i in range(b):
        table[i, :mp - 1] = perm[i * mp:i * mp + mp - 1]
    return (q, pool(lat), None if scale is None else pool(scale), pool(vq),
            pool(vs), pool(vz), u, idx, valid, q_pos), table


@pytest.mark.parametrize("ps", [8, 16])
def test_paged_window_twin_matches_oracle_and_dense(ps):
    inputs = _win_inputs(22, 3, 4, 8, 2, 16, 64, 16, 20, "int8", 8)
    # selected positions must avoid each row's unmapped last page
    q, lat, scale, vq, vs, vz, u, idx, valid, q_pos = inputs
    idx = np.where(valid, np.minimum(idx, 64 - ps - 1), idx).astype(np.int32)
    q_pos = np.minimum(q_pos, 64 - ps - 4).astype(np.int32)
    inputs = (q, lat, scale, vq, vs, vz, u, idx, valid, q_pos)
    pinputs, table = _paged(inputs, ps, 5)
    kw = dict(n_kv=2, n_recent=8, v_bits=8, v_group=16)
    j = jops.sparse_recon_attention_window(
        *_jax_args(pinputs, "int8"), page_table=jnp.asarray(table),
        page_size=ps, backend="xla", **kw)
    t = ops.sparse_recon_attention_window(
        *_torch_args(pinputs, "int8"), page_table=_t(table), page_size=ps,
        **kw)
    for a, b_ in zip(j, t):
        np.testing.assert_allclose(np.asarray(a), b_.numpy(), **TOL)
    dense = ops.sparse_recon_attention_window(*_torch_args(inputs, "int8"),
                                              **kw)
    for a, b_ in zip(t, dense):
        assert torch.equal(a, b_)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_window_q1_and_mask_advance_bitwise(paged):
    """Q = 1 window == the single-token twin; window query t == the
    single-token twin at q_pos + t with valid ∧ idx ≤ q_pos + t − n_recent
    (the gate advance); bit for bit."""
    ql, n_recent = 4, 8
    inputs = _win_inputs(23, 3, ql, 4, 2, 16, 64, 16, 24, "bf16", 8)
    pg = {}
    if paged:
        inputs, table = _paged(inputs, 16, 6)
        pg = dict(page_table=_t(table), page_size=16)
    args = _torch_args(inputs, "bf16")
    q, rest, idx, valid, q_pos = args[0], args[1:7], args[7], args[8], \
        args[9]
    kw = dict(n_kv=2, v_bits=8, v_group=16, **pg)
    one = ops.sparse_recon_attention_window(q[:, :1].contiguous(), *rest,
                                            idx, valid, q_pos, **kw)
    single = ops.sparse_recon_attention(q[:, 0].contiguous(), *rest, idx,
                                        valid, q_pos, **kw)
    for a, b_ in zip(one, single):
        assert torch.equal(a[:, 0], b_)
    win = ops.sparse_recon_attention_window(q, *rest, idx, valid, q_pos,
                                            n_recent=n_recent, **kw)
    for t in range(ql):
        gated = valid & (idx <= (q_pos + t)[:, None] - n_recent)
        m1, l1, o1 = ops.sparse_recon_attention(
            q[:, t].contiguous(), *rest, idx, gated, q_pos + t, **kw)
        assert torch.equal(win[0][:, t], m1) and torch.equal(win[1][:, t], l1)
        assert torch.equal(win[2][:, t], o1)


def test_window_wrapper_limits():
    """The kernel wrapper's checks run before any launch: Q in [1, 8], and
    shared memory that grows with Q against the card's per-block limit."""
    q = torch.zeros((1, 9, 4, 64))
    with pytest.raises(ValueError, match="Q <= 8"):
        sra.sparse_recon_attention_window_cuda(
            q, *[torch.zeros(1)] * 6, torch.zeros((1, 4), dtype=torch.int32),
            torch.zeros((1, 4), dtype=torch.bool), 0, n_kv=4)
    # the group·dh and Q·group terms scale with Q; every supported model
    # fits at Q = 8 (llama2 r 1024, mistral group 4 r 256, yi group 8 r 128)
    # in both bodies: the CUDA-core one (f32 latents) ...
    f32 = dict(k_dtype=torch.float32)
    assert sra.smem_bytes(1024, 128, 1, 8, **f32) \
        - sra.smem_bytes(1024, 128, 1, **f32) == 4 * 7 * (4 * 128 + 32)
    for r, group in ((1024, 1), (256, 4), (128, 8)):
        assert sra.smem_bytes(r, 128, group, 8, **f32) <= sra._SMEM_LIMIT
    # where one block cannot hold a (row, kv head)'s Q·group query rows,
    # they are split over blocks whose shares fit
    assert sra._f32_smem(1024, 128, 8 * 8) > sra._SMEM_LIMIT
    assert sra.query_split(1024, 128, 8, 8, **f32)[0] > 1
    assert sra.smem_bytes(1024, 128, 8, 8, **f32) <= sra._SMEM_LIMIT
    # ... and the tensor-core one (bf16 / int8 latents), whose fixed part
    # grows by the queries, logits, cells and stats of each window query
    # (a ring stage of 32 KB gives way where they no longer fit)
    fixed = [sra.smem_bytes(1024, 128, 1, ql) - sra.ring_stages(128, 1, ql)
             * (128 * 128 + 128 * 128) for ql in (1, 8)]
    # (q, logits and o in f32 per query row; m / l / alpha, 16-byte padded)
    assert fixed[1] - fixed[0] == 4 * 7 * (128 + 128 + 128) + (96 - 16)
    for r, group in ((1024, 1), (256, 4), (128, 8)):
        assert sra.smem_bytes(r, 128, group, 8) <= sra._SMEM_LIMIT
        assert sra.ring_stages(128, group, 8) >= 2
    # group 64 at Q = 8 leaves no two stages in one block: split; at dh
    # 256 not even MAX_SPLIT blocks' shares leave them, and the plan fails
    assert sra._stages(128, 64 * 8, 8, 64) < 2
    assert sra.query_split(1024, 128, 64, 8)[0] > 1
    assert sra.ring_stages(128, 64, 8) >= 2
    assert sra.query_split(1024, 256, 64, 8) == (0, 64 * 8)
    assert sra.ring_stages(256, 64, 8) < 2


# ---------------------------------------------------------------------------
# drafter (a copy of the reference's; the reference's cases)
# ---------------------------------------------------------------------------

def test_ngram_drafter_cases():
    d = NgramDrafter([7, 8, 9, 1, 2, 7, 8, 9, 5, 6, 7, 8, 9])
    assert d.propose(2) == [5, 6]         # latest earlier occurrence wins
    d = NgramDrafter([3, 4, 9, 4])
    assert d.propose(3) == [9, 4, 4]      # copy runs off history, pads last
    assert NgramDrafter([1, 2, 3]).propose(2) == [3, 3]
    assert NgramDrafter([]).propose(2) == [0, 0]
    assert NgramDrafter([5]).propose(0) == []
    d = NgramDrafter([1, 2, 3, 1, 2])
    assert d.propose(1) == [3]
    d.extend([3, 9])
    assert d.history == [1, 2, 3, 1, 2, 3, 9]
    with pytest.raises(ValueError):
        NgramDrafter([1], max_order=0)


# ---------------------------------------------------------------------------
# engine: token-exact with the reference and with sequential decode
# ---------------------------------------------------------------------------

SALS_KW = dict(rank_ratio=0.5, score_ratio=0.5, n_critical=64, n_sink=2,
               n_recent=8, v_bits=8, v_group=32, skip_layers_front=1,
               skip_layers_back=1)
ARCHS = {"llama2-mha": ("paper-llama2-7b", {"n_kv_heads": 4}),
         "yi-gqa": ("yi-9b", {})}


@pytest.fixture(scope="module", params=sorted(ARCHS))
def model(request):
    arch, over = ARCHS[request.param]
    over = dict(dtype="float32", n_layers=3, vocab_size=128, **over)
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    jsals, sals = JSALS(**SALS_KW), SALSConfig(**SALS_KW)
    jp = jtf.init_params(jax.random.PRNGKey(0), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(0), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    return dict(j=(jp, ju, jcfg, jsals), t=(tp, tu, cfg, sals),
                name=request.param)


def _prompts(vocab=128):
    """Two prompts that repeat a base (prompt lookup finds them), one
    random."""
    rng = np.random.default_rng(3)
    base = rng.integers(1, vocab, size=8)
    return [np.tile(base, 3).astype(np.int32)[:18 + 4 * i]
            for i in range(2)] + \
        [rng.integers(1, vocab, size=21).astype(np.int32)]


def _engine(model, spec, **kw):
    tp, tu, cfg, sals = model["t"]
    return ServeEngine(tp, tu, cfg, ServeConfig(
        max_seq_len=128, max_batch=3, sals=sals, spec_window=spec, **kw),
        device="cpu")


def _jengine(model, spec, **kw):
    jp, ju, jcfg, jsals = model["j"]
    return JEngine(jp, ju, jcfg, JServe(max_seq_len=128, max_batch=3,
                                        temperature=0.0, sals=jsals,
                                        spec_window=spec, **kw))


@pytest.mark.parametrize("q", [2, 4, 8])
def test_generate_speculative_token_exact(model, q):
    """Token-exact with the port's ``generate``, the reference's
    ``generate`` and the reference's ``generate_speculative``.  On this jax
    the reference's own window is not bit-exact with its sequential step
    (last-bit differences that flip a quantization code, then a greedy
    token with a margin of ~0.01, depending on the run's history; ROADMAP
    Queue C), so its speculative stream is compared, spec_stats too,
    whenever it matches its sequential one."""
    prompts = _prompts()
    want = [r.tokens for r in
            _engine(model, 0).generate(prompts, max_new_tokens=17)]
    jseq = [r.tokens for r in
            _jengine(model, 0).generate(prompts, max_new_tokens=17)]
    jeng = _jengine(model, q)
    jres = [r.tokens for r in
            jeng.generate_speculative(prompts, max_new_tokens=17)]
    eng = _engine(model, q)
    got = eng.generate_speculative(prompts, max_new_tokens=17)
    ref_exact = all(np.array_equal(a, b_) for a, b_ in zip(jres, jseq))
    for w, js, jr, g in zip(want, jseq, jres, got):
        np.testing.assert_array_equal(g.tokens, w)
        np.testing.assert_array_equal(g.tokens, js)
        if ref_exact:
            np.testing.assert_array_equal(g.tokens, jr)
    if ref_exact:
        assert eng.spec_stats == jeng.spec_stats
    assert eng.spec_stats["committed"] == \
        sum(len(r.tokens) for r in got) - len(got)
    assert eng.last_timing["rounds"] == eng.spec_stats["rounds"]


@pytest.mark.parametrize("drafter", ["garbage", "constant", "oracle"])
def test_generate_speculative_exact_for_any_drafts(model, drafter,
                                                   monkeypatch):
    """Drafts from all-rejected to all-accepted: the stream stays
    token-exact.  ``oracle`` proposes the sequential run's own future
    tokens, so every round commits Q tokens (multi-slot commits)."""
    prompts = _prompts()
    want = [r.tokens for r in
            _engine(model, 0).generate(prompts, max_new_tokens=13)]
    rng = np.random.default_rng(9)

    def propose(self, n_draft):
        if drafter == "garbage":
            return [int(t) for t in rng.integers(1, 128, size=n_draft)]
        if drafter == "constant":
            return [5] * n_draft
        for p, w in zip(prompts, want):
            n = len(self.history) - len(p)
            if list(p) + list(w[:n]) == self.history:
                return (list(w[n:n + n_draft]) + [0] * n_draft)[:n_draft]
        raise AssertionError("history matches no sequential run")

    monkeypatch.setattr(NgramDrafter, "propose", propose)
    eng = _engine(model, 4)
    got = eng.generate_speculative(prompts, max_new_tokens=13)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, w)
    stats = eng.spec_stats
    assert stats["committed"] >= stats["rounds"]
    if drafter == "oracle":
        assert stats["rounds"] == 3     # 12 tokens after prefill, 4 a round
        assert stats["accepted_drafts"] == stats["proposed"]


def test_generate_speculative_eos_and_validation(model):
    prompts = _prompts()
    full = _engine(model, 0).generate(prompts, max_new_tokens=10)
    eos = int(full[0].tokens[3])
    want = _engine(model, 0).generate(prompts, max_new_tokens=10, eos_id=eos)
    got = _engine(model, 4).generate_speculative(prompts, max_new_tokens=10,
                                                 eos_id=eos)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.tokens, w.tokens)
    with pytest.raises(ValueError, match="spec_window"):
        _engine(model, 0).generate_speculative(prompts, max_new_tokens=4)
    with pytest.raises(ValueError, match="window"):
        _engine(model, 8).generate_speculative(prompts, max_new_tokens=101)
    tp, tu, cfg, sals = model["t"]
    with pytest.raises(ValueError, match=r"\[0, 8\]"):
        ServeConfig(sals=sals, spec_window=9)       # the kernel's Q cap
    with pytest.raises(ValueError, match="n_recent"):
        ServeConfig(sals=SALSConfig(**dict(SALS_KW, n_recent=4)),
                    spec_window=6)
    with pytest.raises(ValueError, match="greedy"):
        ServeConfig(sals=sals, spec_window=4, temperature=0.5)
    with pytest.raises(ValueError, match="untiered"):
        ServeConfig(sals=sals, spec_window=4, page_size=16, n_pages=16,
                    hbm_pages=8, max_seq_len=128, prefill_chunk=16)
    cache = LatentKVCache.init(cfg, sals, 1, 1, 32, torch.float32,
                               device="cpu").layer_view(0)
    x = torch.zeros((1, sals.n_recent + 1, cfg.d_model))
    with pytest.raises(ValueError, match="n_recent"):
        sals_window_attend(tp.blocks[1].attn, tu["u"][1], cache, x, 4, cfg,
                           sals)


def _committed(cache, lengths):
    """Every committed byte: SALS per-token rows below each row's length
    (``lengths`` (B,)), the sink / ring windows and lengths, full-precision
    rows below the length."""
    snap = {}
    for name, seg in cache.items():
        if isinstance(seg, LatentKVCache):
            for f in ("k_lat", "k_scale", "v_q", "v_scale", "v_zero"):
                a = getattr(seg, f)
                if a is not None:
                    snap[name, f] = [a[:, i, :n].clone()
                                     for i, n in enumerate(lengths)]
            for f in ("sink_k", "sink_v", "recent_k", "recent_v", "lengths"):
                snap[name, f] = [getattr(seg, f).clone()]
        else:
            for f, a in seg.items():
                snap[name, f] = [a[:, i, :n].clone()
                                 for i, n in enumerate(lengths)]
    return snap


def _assert_same(a, b_):
    assert a.keys() == b_.keys()
    for k in a:
        for x, y in zip(a[k], b_[k]):
            assert torch.equal(x, y), k


def _clone(cache):
    return {k: dataclasses.replace(seg, **{
        f.name: getattr(seg, f.name).clone()
        for f in dataclasses.fields(seg)
        if isinstance(getattr(seg, f.name), torch.Tensor)})
        if isinstance(seg, LatentKVCache)
        else {n: a.clone() for n, a in seg.items()}
        for k, seg in cache.items()}


def test_all_rejected_round_commits_one_sequential_step(model):
    """A Q = 4 round whose drafts are all rejected: the window's forward
    changes no committed byte; the commit then writes slot 0 exactly as the
    sequential write path writes the same K/V, and nothing for the
    rejected slots (the SALS pools compared whole, not only below the
    length).  At Q = 1 the whole round — forward and commit — equals one
    sequential decode step bit for bit.  (At Q = 4 the window's f32 GEMMs
    run with B·Q rows, so its K/V and logits differ from the step's in the
    last bits: logits within 1e-5.)"""
    tp, tu, cfg, sals = model["t"]
    prompts = _prompts()
    lens = np.array([len(p) for p in prompts], np.int32)
    pos = torch.from_numpy(lens)
    toks = np.zeros((3, lens.max()), np.int32)
    for i, p in enumerate(prompts):
        toks[i, :len(p)] = p
    with torch.inference_mode():
        logits, seq = ttf.prefill(tp, tu, cfg, sals,
                                  {"tokens": torch.from_numpy(toks)}, 64,
                                  lengths=pos)
        nxt = logits.argmax(-1).int()
        q1, win = _clone(seq), _clone(seq)
        before = _committed(seq, lens)
        step, _ = ttf.decode_step(tp, tu, seq, nxt, pos, cfg, sals)
        # Q = 1: forward + commit == one sequential step, bitwise
        wl1, aux1 = ttf.decode_window(tp, tu, q1, nxt[:, None], pos, cfg,
                                      sals)
        assert torch.equal(wl1[:, 0], step)
        ttf.commit_window(tu, q1, aux1, pos,
                          torch.ones(3, dtype=torch.int32), cfg, sals)
        _assert_same(_committed(q1, lens + 1), _committed(seq, lens + 1))
        # Q = 4, first draft != the model's next token: all rejected
        bad = (step.argmax(-1).int() + 1) % 128
        wt = torch.stack([nxt, bad, bad, bad], dim=1)
        wl, aux = ttf.decode_window(tp, tu, win, wt, pos, cfg, sals)
        assert not (wt[:, 1] == wl[:, 0].argmax(-1)).any()
        np.testing.assert_allclose(wl[:, 0].numpy(), step.numpy(), **TOL)
        _assert_same(_committed(win, lens), before)      # read-only
        want = _clone(win)
        for si, (i0, i1, mode) in enumerate(ttf.segment_plan(cfg, sals)):
            if mode != "sals":
                continue
            for li in range(i0, i1):
                k0 = aux[f"seg{si}"]["k"][li - i0, :, 0]
                v0 = aux[f"seg{si}"]["v"][li - i0, :, 0]
                want[f"seg{si}"].layer_view(li - i0).write(
                    sals, pos, k0.reshape(3, -1).float() @ tu["u"][li].float(),
                    v0.reshape(3, -1), k0, v0)
        ttf.commit_window(tu, win, aux, pos,
                          torch.ones(3, dtype=torch.int32), cfg, sals)
        s_max = 64
        _assert_same(_committed(win, [s_max] * 3), _committed(want,
                                                              [s_max] * 3))


# ---------------------------------------------------------------------------
# scheduler: token-exact with the reference's speculative branch
# ---------------------------------------------------------------------------

def _shared_prompts(vocab=128):
    """Three prompts sharing a 2-page (32-token) repetitive head."""
    rng = np.random.default_rng(4)
    head = np.tile(rng.integers(1, vocab, 8), 4).astype(np.int32)
    return [np.concatenate([head, rng.integers(1, vocab, k)
                            .astype(np.int32)]) for k in (5, 20, 13)] + \
        [np.tile(rng.integers(1, vocab, 6), 4).astype(np.int32)]


def _run_sched(make_eng, make_req, sched_cls, prompts, mnt):
    sched = sched_cls(make_eng())
    streams, reqs = {}, []
    for i, p in enumerate(prompts):
        req = make_req(p, max_new_tokens=mnt, req_id=i)
        streams[i] = []
        req.on_token = lambda tok, idx, r=i: streams[r].append((idx, tok))
        reqs.append(req)
        sched.submit(req)
    sched.run()
    return sched, reqs, streams


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_scheduler_speculative_matches_reference(model, paged):
    """The port's speculative scheduler is token-exact with the reference's
    sequential scheduler and with its own.  On this jax the reference's
    speculative stream is not reliably equal to its own sequential one
    (its window is not bit-exact with its step; ROADMAP Queue C), so its
    speculative tokens and counters are compared whenever that stream
    matches its sequential one, as in the engine test above."""
    kw = dict(prefill_chunk=8, prefill_token_budget=32, audit_every=1)
    if paged:
        kw.update(page_size=16, n_pages=40)
    prompts = _shared_prompts()
    _, jq, _ = _run_sched(lambda: _jengine(model, 0, **kw), JRequest,
                          JScheduler, prompts, 17)
    js, jr, _ = _run_sched(lambda: _jengine(model, 4, **kw), JRequest,
                           JScheduler, prompts, 17)
    ts, tr, streams = _run_sched(lambda: _engine(model, 4, **kw), Request,
                                 RequestScheduler, prompts, 17)
    seq, sr, _ = _run_sched(lambda: _engine(model, 0, **kw), Request,
                            RequestScheduler, prompts, 17)
    for q, b_, c in zip(jq, tr, sr):
        assert q.state.value == b_.state.value == c.state.value == "done"
        np.testing.assert_array_equal(b_.result.tokens, q.result.tokens)
        np.testing.assert_array_equal(b_.result.tokens, c.result.tokens)
    if all(a.state.value == "done"
           and np.array_equal(a.result.tokens, q.result.tokens)
           for a, q in zip(jr, jq)):
        for a, b_ in zip(jr, tr):
            np.testing.assert_array_equal(b_.result.tokens, a.result.tokens)
        for name in ("spec_rounds", "spec_proposed", "spec_accepted",
                     "spec_committed", "steps", "prefix_hits",
                     "cow_copies"):
            assert int(getattr(ts, name)) == int(getattr(js, name)), name
    assert ts.spec_rounds == ts.steps > 0
    assert ts.spec_accepted > 0          # repetitive heads: drafts land
    if paged:
        assert ts.prefix_hits > 0
    for req in tr:
        idxs = [i for i, _ in streams[req.req_id]]
        assert idxs == list(range(len(req.result.tokens)))
        assert [t for _, t in streams[req.req_id]] == \
            list(req.result.tokens)
    ts.audit_serving_state()


def test_static_mode_uses_speculative_path(model):
    """The static batcher runs ``generate_speculative`` when
    ``spec_window`` > 1: tokens equal the port's sequential ``generate``
    and the JAX static scheduler's sequential tokens (ROADMAP C1: the
    port held to the reference's sequential stream)."""
    prompts = _prompts()
    eng = _engine(model, 4)
    sched = RequestScheduler(eng, mode="static")
    reqs = [Request(p, max_new_tokens=9) for p in prompts]
    for r in reqs:
        sched.submit(r)
    sched.run()
    want = [r.tokens for r in _engine(model, 0).generate(prompts,
                                                         max_new_tokens=9)]
    js = JScheduler(_jengine(model, 0), mode="static")
    jr = [JRequest(p, max_new_tokens=9) for p in prompts]
    for r in jr:
        js.submit(r)
    js.run()
    for r, w, j in zip(reqs, want, jr):
        assert r.done and j.state.value == "done"
        np.testing.assert_array_equal(r.result.tokens, w)
        np.testing.assert_array_equal(r.result.tokens, j.result.tokens)
    assert eng.spec_stats["rounds"] > 0


def test_scheduler_window_span_maps_next_page(model, monkeypatch):
    """Oracle drafts make every round commit Q tokens, so windows cross
    page boundaries: ensure_writable maps every page of the span, and the
    tokens stay exact with the sequential scheduler."""
    kw = dict(prefill_chunk=8, prefill_token_budget=32, audit_every=1,
              page_size=8, n_pages=60)
    prompts = _shared_prompts()
    _, sr, _ = _run_sched(lambda: _engine(model, 0, **kw), Request,
                          RequestScheduler, prompts, 21)
    want = {tuple(p): list(r.result.tokens) for p, r in zip(prompts, sr)}

    def propose(self, n_draft):
        for p, w in want.items():
            n = len(self.history) - len(p)
            if list(p) + w[:n] == self.history:
                return (w[n:n + n_draft] + [0] * n_draft)[:n_draft]
        raise AssertionError("history matches no sequential run")

    monkeypatch.setattr(NgramDrafter, "propose", propose)
    ts, tr, _ = _run_sched(lambda: _engine(model, 8, **kw), Request,
                           RequestScheduler, prompts, 21)
    for p, r in zip(prompts, tr):
        assert list(r.result.tokens) == want[tuple(p)]
    # all but the budget-truncated drafts land
    assert ts.spec_accepted >= ts.spec_proposed // 2


def test_draft_verify_fault_retries_round(model):
    kw = dict(prefill_chunk=8, prefill_token_budget=32, page_size=16,
              n_pages=40, audit_every=1)
    prompts = _shared_prompts()
    _, want, _ = _run_sched(lambda: _engine(model, 4, **kw), Request,
                            RequestScheduler, prompts, 12)
    with faults.injected(faults.FaultSchedule(
            at={"draft_verify": {1, 4, 5}})) as fs:
        ts, got, _ = _run_sched(lambda: _engine(model, 4, **kw), Request,
                                RequestScheduler, prompts, 12)
    assert [p for p, _ in fs.log] == ["draft_verify"] * 3
    assert ts.step_faults == 3
    for a, b_ in zip(want, got):
        assert b_.done
        np.testing.assert_array_equal(b_.result.tokens, a.result.tokens)


def test_nan_window_logits_fail_only_that_row(model):
    """One poisoned row of the window logits: that request alone pays (one
    transient retry, re-run token-exact); the others never notice."""
    kw = dict(prefill_chunk=8, prefill_token_budget=32, audit_every=1)
    prompts = _shared_prompts()[:3]
    _, want, _ = _run_sched(lambda: _engine(model, 4, **kw), Request,
                            RequestScheduler, prompts, 12)
    with faults.injected(faults.FaultSchedule(at={"nan_logits": {2}})) \
            as fs:
        ts, got, _ = _run_sched(lambda: _engine(model, 4, **kw), Request,
                                RequestScheduler, prompts, 12)
    assert fs.log == [("nan_logits", 2)]
    assert ts.retries == 1 and ts.failures == 0
    assert sorted(r.retries for r in got) == [0, 0, 1]
    for a, b_ in zip(want, got):
        assert b_.done
        np.testing.assert_array_equal(b_.result.tokens, a.result.tokens)
    ts.audit_serving_state()


def test_serve_cli_spec_window(capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", "yi-9b", "--device", "cpu", "--page-size", "32",
                "--audit-every", "1", "--spec-window", "4", "--requests",
                "3", "--max-new-tokens", "6"])
    out = capsys.readouterr().out
    assert "3/3 requests ok" in out
    assert "[serve] speculative: window 4" in out


# ---------------------------------------------------------------------------
# CUDA kernels against their twins (only where a card exists)
# ---------------------------------------------------------------------------

@pytest.mark.requires_cuda
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_window_kernel_vs_twin(cuda, paged):
    inputs = _win_inputs(31, 3, 4, 8, 2, 64, 128, 64, 40, "int8", 4)
    pg = {}
    if paged:
        inputs, table = _paged(inputs, 16, 7)
        pg = dict(page_table=_t(table), page_size=16)
    args = _torch_args(inputs, "int8")
    kw = dict(n_kv=2, n_recent=8, v_bits=4, v_group=16, softcap=20.0)
    tw = ops.sparse_recon_attention_window(*args, **kw, **pg)
    dev = [None if a is None else a.to(cuda) for a in args]
    dpg = {k: v.to(cuda) if torch.is_tensor(v) else v for k, v in pg.items()}
    kern = ops.sparse_recon_attention_window(*dev, **kw, **dpg)
    for a, b_ in zip(kern, tw):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-4, atol=1e-4)
    # Q = 1 == the single-token kernel, and the mask advance, bitwise
    q, rest, idx, valid, q_pos = dev[0], dev[1:7], dev[7], dev[8], dev[9]
    one = ops.sparse_recon_attention_window(q[:, :1].contiguous(), *rest,
                                            idx, valid, q_pos, **kw, **dpg)
    kw1 = {k: v for k, v in kw.items() if k != "n_recent"}
    for t in range(4):
        gated = valid & (idx <= (q_pos + t)[:, None] - 8)
        single = ops.sparse_recon_attention(q[:, t].contiguous(), *rest, idx,
                                            gated, q_pos + t, **kw1, **dpg)
        for a, b_ in zip(kern, single):
            assert torch.equal(a[:, t], b_)
        if t == 0:
            for a, b_ in zip(one, single):
                assert torch.equal(a[:, 0], b_)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("lat_dtype", ["bf16", "int8", "f32"])
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_window_kernel_instances_q1_equals_single(cuda, lat_dtype, paged):
    """Each instance of the recon body (bf16 / int8 latents on the tensor
    cores, f32 on the CUDA cores): the window against its twin, a one-query
    window equal to the single-token kernel bit for bit, and (paged) the
    paged window equal to the dense one on the same logical contents."""
    inputs = _win_inputs(32, 3, 3, 8, 2, 128, 300, 128, 200, lat_dtype, 8)
    kw = dict(n_kv=2, n_recent=8, v_bits=8, v_group=16)
    args = _torch_args(inputs, lat_dtype)
    dense_dev = [None if a is None else a.to(cuda) for a in args]
    pg, dpg = {}, {}
    if paged:
        inputs, table = _paged(inputs, 16, 9)
        args = _torch_args(inputs, lat_dtype)
        pg = dict(page_table=_t(table), page_size=16)
        dpg = {k: v.to(cuda) if torch.is_tensor(v) else v
               for k, v in pg.items()}
    tw = ops.sparse_recon_attention_window(*args, **kw, **pg)
    dev = [None if a is None else a.to(cuda) for a in args]
    kern = ops.sparse_recon_attention_window(*dev, **kw, **dpg)
    for a, b_ in zip(kern, tw):
        torch.testing.assert_close(a.cpu(), b_, rtol=1e-4, atol=1e-4)
    q, rest, idx, valid, q_pos = dev[0], dev[1:7], dev[7], dev[8], dev[9]
    one = ops.sparse_recon_attention_window(q[:, :1].contiguous(), *rest,
                                            idx, valid, q_pos, **kw, **dpg)
    kw1 = {k: v for k, v in kw.items() if k != "n_recent"}
    single = ops.sparse_recon_attention(q[:, 0].contiguous(), *rest, idx,
                                        valid, q_pos, **kw1, **dpg)
    for a, b_ in zip(one, single):
        assert torch.equal(a[:, 0], b_)
    if paged:
        dense = ops.sparse_recon_attention_window(*dense_dev, **kw)
        for a, b_ in zip(kern, dense):
            assert torch.equal(a, b_)
