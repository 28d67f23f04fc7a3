"""A traced run of a small cell on the card: the kernels the readers look
for by name are in the trace, and no share of a roofline reads above
100%.  Needs a CUDA card; skips elsewhere (decided inside the test)."""
import copy

import pytest
import torch

import tiny
from portbench import bench

# small, at widths the port's kernels take on the card (head_dim 64,
# r and r* multiples of 8, value groups dividing kv_dim)
CARD = copy.deepcopy(tiny.CONFIG)
CARD.update({"hidden_size": 512, "intermediate_size": 1024,
             "num_attention_heads": 8, "num_key_value_heads": 2,
             "head_dim": 64, "vocab_size": 4096})
CARD["sals"].update({"v_group": 64, "n_critical": 32, "n_sink": 16,
                     "n_recent": 64})
MIX = dict(tiny.SESSION, prompt_len=448, max_seq_len=512, round_steps=32,
           trace_skip=2, trace_steps=4)


@pytest.mark.requires_cuda
def test_traced_session_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    ctx = tiny.ctx(MIX, seconds=2.0, trace=True, config=CARD)
    ctx.device = torch.device("cuda", 0)
    out = bench.drive(ctx)
    assert out.correct, [(c.name, c.value) for c in out.checks]
    names = " ".join(n for n, _, _ in out.trace.ops)
    for k in ("latent_score_pass", "topk_select_kernel", "sra_kernel"):
        assert k in names
    for m in ("latent_topk_roofline.decode", "sra_roofline.decode"):
        v = bench.load_reader(m)(ctx, out)
        assert v is not None and 0 < v <= 100
    assert 0 < out.trace.busy_s <= out.trace.window_s
