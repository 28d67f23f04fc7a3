"""The launchers' shared config rule, the scheduler's ``max_batch`` and the
serving launcher's ``--ckpt``, against the JAX reference on the CPU.

* ``launch.model_config``: ``--reduced`` on the card takes head_dim 64 (the
  reduced configs' 32 is below what the flash and recon kernels take), the
  CPU keeps the reference's config; the SALS settings the serving
  launcher builds on it pass every check of the top-k and recon wrappers
  (which run before their device check) for every attention family;
* ``RequestScheduler(engine, max_batch=...)``: static mode drains batches
  of that size, as the reference's does, to the reference's tokens;
  continuous mode refuses a value other than the engine's with the
  reference's ``ValueError``;
* ``launch.serve --ckpt``: a checkpoint that the reference's
  ``checkpoint.save`` wrote is served by the port's launcher to the
  reference launcher's greedy tokens (reduced qwen2-1.5b in f32)."""
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import checkpoint as jckpt
from repro.config import SALSConfig as JSALS
from repro.config import ServeConfig as JServe
from repro.config import TrainConfig as JTrainConfig
from repro.configs import get_config as jax_get_config
from repro.launch import serve as jserve_cli
from repro.models import transformer as jtf
from repro.serve import Request as JRequest
from repro.serve import RequestScheduler as JScheduler
from repro.serve import ServeEngine as JEngine
from repro.train import trainer as jtrainer
from repro_torch import launch
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import _ARCH_MODULES, get_config
from repro_torch.convert import params_from_numpy
from repro_torch.kernels import latent_score as ls
from repro_torch.kernels import sparse_recon_attention as sra
from repro_torch.launch import serve as serve_cli
from repro_torch.serve import Request, RequestScheduler, ServeEngine

torch.set_num_threads(1)
CUDA = torch.device("cuda")


# ---------------------------------------------------------------------------
# C3: the config the launchers pick on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["yi-9b", "qwen2-1.5b", "hymba-1.5b"])
def test_reduced_config_on_the_card_takes_head_dim_64(arch):
    """Computed without a card: on a CUDA device the reduced config has
    head_dim 64 and is otherwise the reference's reduced config; on the
    CPU it is the reference's, head_dim 32."""
    logged = []
    card = launch.model_config(arch, True, CUDA, log=logged.append,
                               who="serve")
    cpu = launch.model_config(arch, True, torch.device("cpu"),
                              log=logged.append)
    ref = jax_get_config(arch).reduced()
    assert card.head_dim == 64 and cpu.head_dim == ref.head_dim == 32
    assert len(logged) == 1 and logged[0].startswith("[serve] --reduced")
    for name in ("n_layers", "d_model", "n_heads", "n_kv_heads", "d_ff",
                 "vocab_size", "family", "dtype"):
        assert getattr(card, name) == getattr(cpu, name) == \
            getattr(ref, name), name
    assert launch.model_config(arch, False, CUDA) == get_config(arch)


ATTENTION_ARCHS = [a for a in sorted(_ARCH_MODULES)
                   if get_config(a).is_decoder and get_config(a).has_attention]


@pytest.mark.parametrize("ratio", ["0.25", "0.125"])
@pytest.mark.parametrize("arch", ATTENTION_ARCHS)
def test_launcher_sals_on_the_card_passes_the_wrappers(arch, ratio):
    """The serving launcher's SALS settings on its card config (r =
    ratio x kv_dim, v_group min(32, kv_dim), N_c 64, sink 4, recent 16):
    the top-k and the recon wrappers run every check they make before the
    device check, and stop only there (the tensors lie on the CPU)."""
    cfg = launch.model_config(arch, True, CUDA, log=lambda *_: None)
    sals = serve_cli.sals_config(cfg, ratio)
    assert (sals.n_critical, sals.n_sink, sals.n_recent) == (64, 4, 16)
    b, s, kvd = 2, 128, cfg.kv_dim
    r, r_star = sals.rank(kvd), sals.score_rank(kvd)
    k_lat = torch.zeros((b, s, r), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA device"):
        ls.latent_topk_cuda(torch.zeros((b, r_star)), k_lat, None, s - 1,
                            n_critical=sals.n_critical, n_sink=sals.n_sink,
                            n_recent=sals.n_recent)
    code_w = kvd if sals.v_bits == 8 else kvd // 2
    code = torch.int8 if sals.v_bits == 8 else torch.uint8
    groups = torch.zeros((b, s, kvd // sals.v_group), dtype=torch.bfloat16)
    for ql in (1, 4):     # a decode step, a verify window of 4
        q = torch.zeros((b, ql, cfg.n_heads, cfg.head_dim),
                        dtype=torch.bfloat16)
        with pytest.raises(ValueError, match="CUDA device"):
            sra.sparse_recon_attention_window_cuda(
                q, k_lat, None, torch.zeros((b, s, code_w), dtype=code),
                groups, groups.clone(),
                torch.zeros((kvd, r), dtype=torch.bfloat16),
                torch.zeros((b, sals.n_critical), dtype=torch.int32),
                torch.zeros((b, sals.n_critical), dtype=torch.bool), s - 1,
                n_kv=cfg.n_kv_heads, n_recent=sals.n_recent,
                v_bits=sals.v_bits, v_group=sals.v_group)


# ---------------------------------------------------------------------------
# C4: RequestScheduler(engine, max_batch=...)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dense():
    """Reduced qwen2-1.5b in f32, full attention, one set of weights in
    both packages."""
    over = dict(dtype="float32")
    jcfg = jax_get_config("qwen2-1.5b").reduced(**over)
    cfg = get_config("qwen2-1.5b").reduced(**over)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    return jp, jcfg, tp, cfg


def _requests(cls, vocab, n=5):
    rng = np.random.default_rng(5)
    return [cls(rng.integers(1, vocab, int(rng.integers(6, 24)))
                .astype(np.int32), max_new_tokens=3 + i % 3)
            for i in range(n)]


def test_static_max_batch_drains_the_references_batches(dense):
    """``max_batch=2`` over an engine of 4 slots: the static scheduler
    drains batches of 2, 2, 1 (shortest prompts first), each request's
    tokens equal to the reference's under the same argument."""
    jp, jcfg, tp, cfg = dense
    kw = dict(max_seq_len=64, max_batch=4, max_new_tokens=8)
    runs = {}
    for name, sched in (
            ("ref", JScheduler(JEngine(jp, None, jcfg, JServe(
                sals=JSALS(enabled=False), **kw)), max_batch=2,
                mode="static")),
            ("port", RequestScheduler(
                ServeEngine(tp, None, cfg,
                            ServeConfig(sals=SALSConfig(enabled=False), **kw),
                            device="cpu"), max_batch=2, mode="static"))):
        reqs = _requests(JRequest if name == "ref" else Request,
                         cfg.vocab_size)
        for r in reqs:
            sched.submit(r)
        batches = []
        sched.run(on_batch=lambda b: batches.append(
            sorted(len(r.prompt) for r in b)))
        assert sched.max_batch == 2
        runs[name] = ([np.asarray(r.result.tokens).tolist() for r in reqs],
                      batches)
    assert runs["port"] == runs["ref"]
    assert [len(b) for b in runs["port"][1]] == [2, 2, 1]


def test_continuous_refuses_a_max_batch_other_than_the_engines(dense):
    jp, jcfg, tp, cfg = dense
    kw = dict(max_seq_len=64, max_batch=4)
    jsched = JScheduler(JEngine(jp, None, jcfg, JServe(
        sals=JSALS(enabled=False), **kw)), max_batch=2)
    sched = RequestScheduler(
        ServeEngine(tp, None, cfg, ServeConfig(sals=SALSConfig(
            enabled=False), **kw), device="cpu"), max_batch=2)
    msgs = []
    for s, cls in ((jsched, JRequest), (sched, Request)):
        s.submit(_requests(cls, cfg.vocab_size, 1)[0])
        with pytest.raises(ValueError, match="slot arena") as e:
            s.run()
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1] == ("continuous mode uses the engine's slot "
                                  "arena: max_batch 2 != engine 4")
    # the engine's own value (or none) runs
    assert RequestScheduler(sched.engine, max_batch=4).max_batch == 4
    assert RequestScheduler(sched.engine).max_batch == 4


# ---------------------------------------------------------------------------
# --ckpt: the reference's checkpoint served by the port's launcher
# ---------------------------------------------------------------------------

def _recording(cls, into: list):
    """``cls`` whose ``run`` records each request's tokens."""

    class Recording(cls):
        def run(self, *a, **kw):
            done = super().run(*a, **kw)
            into.extend((r.req_id, np.asarray(r.result.tokens).tolist())
                        for r in done)
            return done

    return Recording


def test_serve_ckpt_gives_the_reference_launchers_tokens(
        tmp_path, monkeypatch, capsys):
    """A reference train state of reduced qwen2-1.5b in f32 (weights from
    another seed than the launchers' own), saved at step 5 by the
    reference's ``checkpoint.save``, then both launchers with ``--ckpt``:
    both print the step, and the port's greedy tokens equal the
    reference's request by request."""
    # both launchers at f32 (weights and caches), for exact tokens
    monkeypatch.setattr(jserve_cli, "get_config", lambda a: dataclasses
                        .replace(jax_get_config(a), dtype="float32"))
    monkeypatch.setattr(launch, "get_config", lambda a: dataclasses
                        .replace(get_config(a), dtype="float32"))
    jcfg = jax_get_config("qwen2-1.5b").reduced(dtype="float32")
    state = jtrainer.init_state(jax.random.PRNGKey(7), jcfg, JTrainConfig(),
                                jnp.float32)
    ck = str(tmp_path / "ck")
    jckpt.save(ck, 5, state)
    argv = ["--arch", "qwen2-1.5b", "--requests", "3", "--prompt-len", "24",
            "--max-new-tokens", "6", "--max-seq", "64", "--prefill-chunk",
            "16", "--ckpt", ck]
    tokens = {"ref": [], "port": []}
    monkeypatch.setattr(jserve_cli, "RequestScheduler",
                        _recording(JScheduler, tokens["ref"]))
    monkeypatch.setattr(serve_cli, "RequestScheduler",
                        _recording(RequestScheduler, tokens["port"]))
    monkeypatch.setattr(sys, "argv", ["serve"] + argv)
    jserve_cli.main()
    ref_out = capsys.readouterr().out
    serve_cli.main(argv + ["--device", "cpu"])
    out = capsys.readouterr().out
    for text in (ref_out, out):
        assert "[serve] loaded checkpoint step 5" in text
        assert "3/3 requests ok" in text
    order = lambda rows: [t for _, t in sorted(rows)]
    assert len(tokens["port"]) == 3
    assert order(tokens["port"]) == order(tokens["ref"])
