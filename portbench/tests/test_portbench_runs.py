"""Whole runs at a tiny size on the CPU: the harness past its look for a
card, the port's CPU paths, the reference.  Sound runs come out correct;
the timed path broken underneath comes out not correct, once per fault a
cell can have (a step that leaves its state unchanged, half of the batch
left out, a token altered where it is produced; these cells run on one
chip, so no exchange between chips can be left out); and the fp8 control
reads above the limits.  The session cell also judges the cache its
steps wrote: a step that leaves its state unchanged and the fp8 control
both read above that limit."""
import pytest
import torch

import tiny
from portbench import bench, faults, traffic, weights
from portbench.reference import load as load_reference
from portbench.tools import control
from portbench.yardstick import compare

MIXES = {"session": tiny.SESSION, "open_loop": tiny.OPEN_LOOP}
SECONDS = {"session": 1.0, "open_loop": 2.0}


def run(kind, seed=7, **kw):
    return bench.drive(tiny.ctx(MIXES[kind], seed=seed,
                                seconds=SECONDS[kind], **kw))


@pytest.mark.parametrize("kind", ["session", "open_loop"])
def test_sound_run_is_correct(kind):
    out = run(kind)
    assert out.correct, [(c.name, c.value) for c in out.checks]
    assert out.attempted > 0 and out.failed == 0


@pytest.mark.parametrize("kind", ["session", "open_loop"])
@pytest.mark.parametrize("name", faults.NAMES)
def test_broken_timed_path_is_not_correct(kind, name):
    with faults.planted(name):
        out = run(kind)
    gap = {c.name: c.value for c in out.checks}["max_logit_gap"]
    assert not out.correct and gap > tiny.LIMITS["max_logit_gap"], gap


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_fp8_control_reads_above_the_limit(seed):
    mix = dict(tiny.SESSION, rows=8)
    ctx = tiny.ctx(mix, seed=seed)
    w = weights.make_weights(ctx.spec, seed, ctx.device)
    cal = torch.as_tensor(traffic.calibration_tokens(
        tiny.CONFIG["calibration"], ctx.spec.vocab_size, seed))
    ref = load_reference(ctx.spec, w)
    ref.fit_projectors(cal)
    low = load_reference(ctx.spec, weights.fp8_weights(w), fp8=True)
    low.fit_projectors(cal)
    gap = 0.0
    for p in traffic.session_inputs(mix, 512, seed).prompts:
        p = torch.as_tensor(p, dtype=torch.long)
        # the reference's own greedy tokens at the prompt's last 48 places
        cont = ref.serve_logits(p[:-48], [p[-48:]])[0].argmax(dim=1)
        gap = max(gap, compare.control_gap(
            ref.serve_logits(p[:-48], [cont]),
            low.serve_logits(p[:-48], [cont])))
    assert gap > tiny.LIMITS["max_logit_gap"], gap


def test_state_fault_fails_the_cache_check():
    with faults.planted("state_unchanged"):
        out = run("session")
    err = {c.name: c.value for c in out.checks}["max_cache_err"]
    assert not out.correct and err > tiny.LIMITS["max_cache_err"], err


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_fp8_control_reads_above_the_cache_limit(seed):
    out = run("session", seed=seed)
    sound = {c.name: c.value for c in out.checks}["max_cache_err"]
    low = control.control_reading(tiny.ctx(tiny.SESSION, seed=seed),
                                  out.data["check_inputs"])
    assert sound < tiny.LIMITS["max_cache_err"] < low["max_cache_err"], \
        (sound, low)
