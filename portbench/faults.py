"""Faults planted in the timed path, for the checks' own tests: each must
make a run come out not correct.  A cell on one chip can have three: a
step that leaves its state unchanged, half of the batch left out, a
token altered where it is produced.  ``tests/test_portbench_runs.py``
plants them at a tiny size on the CPU; ``tools/control.py --fault`` at a
cell's own size on the card."""
from __future__ import annotations

import contextlib

from portbench import program

NAMES = ("state_unchanged", "half_batch", "token_altered")


@contextlib.contextmanager
def planted(name: str):
    """The port patched with fault ``name`` for the body."""
    program.import_port()
    from repro_torch.core.latent_cache import LatentKVCache
    from repro_torch.models import attention
    from repro_torch.serve.engine import ServeEngine
    saved = []

    def patch(obj, attr, new):
        saved.append((obj, attr, getattr(obj, attr)))
        setattr(obj, attr, new)

    if name == "state_unchanged":
        # the decode step writes none of its cache: no latent, value or
        # window of a SALS layer, no K/V of a full layer
        full = attention.attend_decode_full
        patch(LatentKVCache, "write", lambda self, *a, **k: self)
        patch(attention, "attend_decode_full",
              lambda p, x, cfg, k, v, pos: full(p, x, cfg, k.clone(),
                                                v.clone(), pos))
    elif name == "half_batch":
        decode = ServeEngine.decode

        def half(self, tokens, cache, positions):
            # every odd row takes its even neighbour's logits: half of the
            # rows never computed, whichever slots are live
            logits, cache = decode(self, tokens, cache, positions)
            n = logits.shape[0] // 2 * 2
            logits[1:n:2] = logits[0:n:2]
            return logits, cache
        patch(ServeEngine, "decode", half)
    elif name == "token_altered":
        sample = ServeEngine.sample_checked
        calls = [0]

        def altered(self, logits):
            tok, ok = sample(self, logits)
            calls[0] += 1
            if calls[0] % 4 == 0:
                tok = tok.clone()
                tok[0] = (tok[0] + 1) % self.cfg.vocab_size
            return tok, ok
        patch(ServeEngine, "sample_checked", altered)
    else:
        raise ValueError(f"unknown fault {name!r} ({', '.join(NAMES)})")
    try:
        yield
    finally:
        for obj, attr, old in reversed(saved):
            setattr(obj, attr, old)
