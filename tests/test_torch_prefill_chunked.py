"""Port parity for chunked prefill: ``transformer.prefill_chunk`` of the
port against the JAX reference's, chunk by chunk, from the same weights
and projectors on a ragged right-padded batch, the offset a Python int or
a device tensor against the reference's traced one (per-chunk logits
within rtol = atol = 1e-4, the engine test's tolerance); and inside the port,
chunked == monolithic prefill as the reference's own test holds it: the
last-token logits and cache fields within 1e-4, value codes within one
step, and identical greedy decode from either cache; the engine's
``prefill_one`` chunk loop gives the same logits for one request."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.config import SALSConfig as JSALS
from repro.configs import get_config as jax_get_config
from repro.core import calibration as jcal
from repro.models import transformer as jtf
from repro_torch.config import SALSConfig, ServeConfig
from repro_torch.configs import get_config
from repro_torch.convert import params_from_numpy, projectors_from_numpy
from repro_torch.models import transformer as ttf
from repro_torch.serve import ServeEngine

torch.set_num_threads(1)
TOL = dict(rtol=1e-4, atol=1e-4)
SALS_KW = dict(n_critical=10, n_sink=2, n_recent=8, v_group=16,
               skip_layers_front=1, skip_layers_back=1)
MAX_SEQ, CHUNK = 64, 8


CASES = [("paper-llama2-7b", {"n_kv_heads": 4}, 8, "bfloat16"),   # MHA
         ("yi-9b", {}, 4, "int8"),                                 # GQA
         ("paligemma-3b", {}, 8, "bfloat16"),    # MQA, tokens only
         ("qwen2-1.5b", {}, 8, "int8")]          # GQA, QKV bias


@pytest.mark.parametrize("arch,over,v_bits,lat_dtype,tensor_off", [
    pytest.param(*case, tensor_off,
                 id=f"{case[0]}-over{i}-{case[2]}-{case[3]}"
                 + ("-tensor_off" if tensor_off else ""))
    for tensor_off in (False, True) for i, case in enumerate(CASES)])
def test_prefill_chunk_matches_reference_and_monolithic(arch, over, v_bits,
                                                        lat_dtype,
                                                        tensor_off):
    """``tensor_off``: the chunk offset as a 0-d int32 tensor, as the
    engine's chunk program passes it, against the JAX step's traced
    offset; else a Python int."""
    over = dict(dtype="float32", n_layers=4, **over)
    jcfg = jax_get_config(arch).reduced(**over)
    cfg = get_config(arch).reduced(**over)
    kw = dict(SALS_KW, v_bits=v_bits, k_latent_dtype=lat_dtype)
    jsals, sals = JSALS(**kw), SALSConfig(**kw)
    jp = jtf.init_params(jax.random.PRNGKey(1), jcfg, jnp.float32)
    ju = jcal.random_layer_projectors(jax.random.PRNGKey(2), jcfg, jsals,
                                      jcfg.n_layers)
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), cfg, device="cpu")
    tu = projectors_from_numpy({"u": np.asarray(ju["u"])}, device="cpu")
    rng = np.random.default_rng(4)
    lens = np.array([29, 14], np.int32)
    n_chunks = -(-int(lens.max()) // CHUNK)
    toks = np.zeros((2, n_chunks * CHUNK), np.int32)
    for i, n in enumerate(lens):
        toks[i, :n] = rng.integers(1, cfg.vocab_size, n)

    jstep = jax.jit(lambda c, s, t, off: jtf.prefill_chunk(
        jp, ju, jcfg, jsals, c, s, {"tokens": t}, off, jnp.asarray(lens)))
    jc = jtf.init_cache(jcfg, jsals, 2, MAX_SEQ)
    js = jtf.init_prefill_scratch(jcfg, jsals, 2, MAX_SEQ)
    tc = ttf.init_cache(cfg, sals, 2, MAX_SEQ, device="cpu")
    ts = ttf.init_prefill_scratch(cfg, sals, 2, MAX_SEQ, device="cpu")
    len_t = torch.from_numpy(lens)
    last = torch.zeros((2, cfg.vocab_size))
    with torch.inference_mode():
        for j in range(n_chunks):
            chunk = toks[:, j * CHUNK:(j + 1) * CHUNK]
            jl, jc, js = jstep(jc, js, jnp.asarray(chunk),
                               jnp.int32(j * CHUNK))
            off = torch.tensor(j * CHUNK, dtype=torch.int32) \
                if tensor_off else j * CHUNK
            tl, tc, ts = ttf.prefill_chunk(
                tp, tu, cfg, sals, tc, ts,
                {"tokens": torch.from_numpy(chunk)}, off, len_t)
            np.testing.assert_allclose(np.asarray(jl), tl.numpy(), **TOL,
                                       err_msg=f"chunk {j}")
            # a row's real next-token logits come from the chunk holding
            # its last prompt token; later chunks only carry its pads
            mine = (lens - 1) // CHUNK == j
            last[mine] = tl[torch.from_numpy(mine)]

        ml, mc = ttf.prefill(tp, tu, cfg, sals,
                             {"tokens": torch.from_numpy(toks)}, MAX_SEQ,
                             lengths=len_t)
        np.testing.assert_allclose(ml.numpy(), last.numpy(), **TOL)
        for name, seg_m in mc.items():
            seg_c = tc[name]
            if isinstance(seg_m, dict):              # full segment
                for f in ("k", "v"):
                    torch.testing.assert_close(seg_c[f], seg_m[f], **TOL)
                continue
            assert torch.equal(seg_c.lengths, seg_m.lengths)
            codes = ["v_q"]
            for f in ("k_lat", "k_scale", "sink_k", "sink_v", "recent_k",
                      "recent_v", "v_scale", "v_zero"):
                a, b = getattr(seg_c, f), getattr(seg_m, f)
                if a is None or a.dtype == torch.int8:
                    codes += [f] if a is not None else []
                    continue
                torch.testing.assert_close(a.float(), b.float(), **TOL)
            # integer codes: at most one step of drift at bin boundaries, as
            # the reference's own chunked-vs-monolithic test allows
            for f in codes:
                dq = (getattr(seg_c, f).int() - getattr(seg_m, f).int())
                assert int(dq.abs().max()) <= 1, f

        def greedy(logits, cache, n=6):
            tok = logits.argmax(-1).int()
            seq = [tok]
            for t in range(n - 1):
                lg, cache = ttf.decode_step(tp, tu, cache, tok, len_t + t,
                                            cfg, sals)
                tok = lg.argmax(-1).int()
                seq.append(tok)
            return torch.stack(seq, 1)

        assert torch.equal(greedy(last, tc), greedy(ml, mc))

        # the engine's single-request chunk loop gives row 0's logits
        eng = ServeEngine(tp, tu, cfg, ServeConfig(
            max_seq_len=MAX_SEQ, prefill_chunk=CHUNK, sals=sals),
            device="cpu")
        one, _ = eng.prefill_one(toks[0, :lens[0]])
        torch.testing.assert_close(one[0], last[0], **TOL)
