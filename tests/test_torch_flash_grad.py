"""Flash attention with a gradient: the port's twins and autograd Function
against the reference's FlashAttention-2 custom VJP
(``repro.kernels.ops._flash_xla``: ``_flash_fwd_impl`` saves (O, LSE),
``_flash_bwd_rule`` recomputes P from LSE), on the same seeded numpy
inputs.

* ``attention_lse_ref``'s LSE and ``attention_bwd_ref``'s (dq, dk, dv)
  against ``jax.vjp`` of ``_flash_xla`` in f32, rtol = atol = 1e-5:
  causal, non-causal, prefix-LM, softcap, GQA (the reference takes K/V
  expanded; the port's dK / dV come back summed over each group) and
  Sq < Sk;
* ``FlashAttentionFn`` on the CPU against ``torch.autograd`` through
  ``attention_ref``, and ``torch.autograd.gradcheck`` in f64;
* bf16: the twin rounds P and dS where ``_flash_bwd_rule`` does, held to
  the reference's bf16 gradients within a bf16 rounding step of each
  tensor's scale;
* outside autograd (``torch.no_grad()``, or no input requiring grad) the
  call is the plain forward: no LSE, no Function;
* the backward kernels' geometry (``bwd_tiles`` / ``bwd_smem_bytes``,
  mirrors of the CUDA source) fits one block's shared memory at every
  head_dim, and the wrapper's refusals come before its device check;
* ``requires_cuda``: the forward kernel's LSE and the backward kernel
  against the twins on the card (relative max error 1e-2 of each tensor's
  max), the O of the forward with LSE bitwise equal to the one without,
  and two backward runs bitwise equal; sequence lengths that are
  multiples of no tile, a prefix past one tile, group 6, Hkv = H, dh 256
  non-causal with Sq < Sk, dh 80 (non-causal, GQA with Sq < Sk,
  softcap); and planted faults (a zeroed LSE slice in the
  last query tile, a K tile past the diagonal) that the kernels follow
  as the twin does.  Those cases import no JAX, so they run on a machine
  with a card (``pytest --noconftest -m requires_cuda``)."""
import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, ref

torch.set_num_threads(1)
TOL = dict(rtol=1e-5, atol=1e-5)

# (name, B, Sq, Sk, H, Hkv, dh, causal, softcap, prefix_len)
CASES = [
    ("causal", 2, 16, 16, 4, 4, 16, True, 0.0, 0),
    ("non-causal", 2, 12, 12, 4, 4, 16, False, 0.0, 0),
    ("prefix-LM", 2, 16, 16, 4, 4, 16, True, 0.0, 5),
    ("softcap", 2, 16, 16, 4, 4, 16, True, 20.0, 0),
    ("GQA 8/2", 2, 16, 16, 8, 2, 16, True, 0.0, 0),
    ("Sq<Sk causal", 2, 8, 24, 4, 2, 16, True, 0.0, 0),
    ("Sq<Sk non-causal softcap", 1, 6, 10, 4, 1, 16, False, 30.0, 0),
]


def _inputs(seed, b, sq, sk, h, hkv, dh):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    k = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    v = rng.standard_normal((b, sk, hkv, dh)).astype(np.float32)
    do = rng.standard_normal((b, sq, h, dh)).astype(np.float32)
    return q, k, v, do


def _reference_vjp(q, k, v, do, causal, softcap, prefix_len, dtype):
    """(O, LSE, dq, dk, dv) of the reference's custom VJP, K/V expanded to
    the query heads as its callers pass them."""
    import jax
    import jax.numpy as jnp
    from repro.kernels import ops as jops
    h, hkv = q.shape[2], k.shape[2]
    kx = np.repeat(k, h // hkv, axis=2)
    vx = np.repeat(v, h // hkv, axis=2)
    args = [jnp.asarray(x, dtype) for x in (q, kx, vx)]
    out, lse = jops._flash_fwd_impl(*args, causal, softcap, prefix_len)
    _, vjp = jax.vjp(lambda a, b, c: jops._flash_xla(
        a, b, c, causal, softcap, prefix_len), *args)
    dq, dkx, dvx = vjp(jnp.asarray(do, dtype))
    f32 = lambda x: np.array(jnp.asarray(x, jnp.float32))
    return f32(out), f32(lse), f32(dq), f32(dkx), f32(dvx)


def _fold(x, hkv):
    """(B, S, H, dh) -> (B, S, Hkv, dh): each group's heads summed."""
    b, s, h, dh = x.shape
    return x.reshape(b, s, hkv, h // hkv, dh).sum(axis=3)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_twins_match_reference_vjp(case):
    _, b, sq, sk, h, hkv, dh, causal, softcap, pl = case
    q, k, v, do = _inputs(1, b, sq, sk, h, hkv, dh)
    import jax.numpy as jnp
    r_out, r_lse, r_dq, r_dk, r_dv = _reference_vjp(
        q, k, v, do, causal, softcap, pl, jnp.float32)
    mk = dict(causal=causal or pl > 0, softcap=softcap, prefix_len=pl)
    t = [torch.from_numpy(x) for x in (q, k, v, do)]
    out, lse = ref.attention_lse_ref(t[0], t[1], t[2], **mk)
    np.testing.assert_allclose(out.numpy(), r_out, **TOL)
    np.testing.assert_allclose(lse.numpy(), r_lse, **TOL)
    dq, dk, dv = ref.attention_bwd_ref(t[0], t[1], t[2], out, lse, t[3],
                                       **mk)
    assert dk.shape == (b, sk, hkv, dh) and dv.shape == dk.shape
    np.testing.assert_allclose(dq.numpy(), r_dq, **TOL)
    np.testing.assert_allclose(dk.numpy(), _fold(r_dk, hkv), **TOL)
    np.testing.assert_allclose(dv.numpy(), _fold(r_dv, hkv), **TOL)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_function_matches_autograd_of_twin(case):
    """The CPU branch of FlashAttentionFn (the path the card replaces by
    its kernels) against autograd through the materialized twin."""
    _, b, sq, sk, h, hkv, dh, causal, softcap, pl = case
    q, k, v, do = (torch.from_numpy(x) for x in
                   _inputs(2, b, sq, sk, h, hkv, dh))
    mk = dict(causal=causal, softcap=softcap, prefix_len=pl)
    grads = []
    for fn in (ops.flash_attention, ref.attention_ref):
        leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
        out = fn(*leaves, **{**mk, "causal": causal or pl > 0})
        out.backward(do)
        grads.append([out.detach()] + [x.grad for x in leaves])
    for a, r in zip(*grads):
        torch.testing.assert_close(a, r, **TOL)


@pytest.mark.parametrize("causal,softcap,prefix_len,sq,sk,hkv", [
    (True, 0.0, 0, 6, 6, 2), (False, 0.0, 0, 5, 7, 4),
    (True, 30.0, 0, 4, 9, 1), (True, 0.0, 3, 8, 8, 2)])
def test_gradcheck_f64(causal, softcap, prefix_len, sq, sk, hkv):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, sq, 4, 8, dtype=torch.float64, generator=g)
    k = torch.randn(2, sk, hkv, 8, dtype=torch.float64, generator=g)
    v = torch.randn(2, sk, hkv, 8, dtype=torch.float64, generator=g)
    leaves = [x.requires_grad_(True) for x in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda a, b, c: ops.FlashAttentionFn.apply(a, b, c, causal, softcap,
                                                   prefix_len), leaves)


@pytest.mark.parametrize("case", [CASES[0], CASES[3], CASES[4], CASES[5]],
                         ids=["causal", "softcap", "GQA", "Sq<Sk"])
def test_bf16_rounding_points_match_reference(case):
    """In bf16 the twin rounds P and dS to bf16 before their products, as
    ``_flash_bwd_rule`` does: its gradients sit within one bf16 rounding
    step (2^-8) of each tensor's scale of the reference's.  Dropping the
    rounding (the f32 twin on the same bf16 inputs) moves dq further."""
    _, b, sq, sk, h, hkv, dh, causal, softcap, pl = case
    q, k, v, do = _inputs(4, b, sq, sk, h, hkv, dh)
    import jax.numpy as jnp
    r_out, r_lse, r_dq, r_dk, r_dv = _reference_vjp(
        q, k, v, do, causal, softcap, pl, jnp.bfloat16)
    mk = dict(causal=causal, softcap=softcap, prefix_len=pl)
    bf = [torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v, do)]
    out = torch.from_numpy(r_out).to(torch.bfloat16)
    lse = torch.from_numpy(r_lse)
    got = ref.attention_bwd_ref(bf[0], bf[1], bf[2], out, lse, bf[3], **mk)
    want = (r_dq, _fold(r_dk, hkv), _fold(r_dv, hkv))

    def err(a, r):
        return float(np.abs(a.float().numpy() - r).max() / np.abs(r).max())

    errs = [err(a, r) for a, r in zip(got, want)]
    assert max(errs) <= 2.0 ** -8, errs
    f32 = [x.float() for x in bf]
    unrounded = ref.attention_bwd_ref(f32[0], f32[1], f32[2], out.float(),
                                      lse, f32[3], **mk)
    assert err(unrounded[0], want[0]) >= errs[0]


def test_no_function_and_no_lse_outside_autograd(monkeypatch):
    """Under ``torch.no_grad()``, or with no input requiring grad, the call
    is the plain forward: no LSE twin, no FlashAttentionFn node."""
    q, k, v, _ = (torch.from_numpy(x) for x in _inputs(5, 1, 8, 8, 2, 2, 16))
    q.requires_grad_(True)
    calls = []
    real = ref.attention_lse_ref
    monkeypatch.setattr(ref, "attention_lse_ref",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    with torch.no_grad():
        out = ops.flash_attention(q, k, v, causal=True)
    assert out.grad_fn is None and not calls
    out = ops.flash_attention(q.detach(), k, v, causal=True)
    assert out.grad_fn is None and not calls
    out = ops.flash_attention(q, k, v, causal=True)
    assert type(out.grad_fn).__name__ == "FlashAttentionFnBackward"
    assert calls == [1]
    torch.testing.assert_close(
        out.detach(), ref.attention_ref(q.detach(), k, v, causal=True))


# ---------------------------------------------------------------------------
# The backward kernels' geometry and refusals (CPU)
# ---------------------------------------------------------------------------

SMEM_PER_BLOCK = 232448    # what one H100 block may use


@pytest.mark.parametrize("dh", [64, 80, 128, 256])
def test_bwd_geometry_fits_shared_memory(dh):
    """Both kernels' blocks fit in shared memory, the dK/dV block's keys
    are whole 64-key warpgroup tiles (two, or one shared by the split
    body at dh 256), and every streamed tile's {LSE, D} rows lie inside
    the scratch rows of its head (Sq rounded up to 128)."""
    from repro_torch.kernels import flash_attention as fa
    t = fa.bwd_tiles(dh)
    dkdv, dq = fa.bwd_smem_bytes(dh)
    assert 0 < dkdv <= SMEM_PER_BLOCK and 0 < dq <= SMEM_PER_BLOCK
    assert t["dkdv_keys"] == (64 if t["dkdv_split"] else 128)
    assert t["dkdv_split"] == (dh > 128)
    assert t["dq_rows"] in (64, 128) and t["dq_keys"] % 16 == 0
    for rows in (t["dkdv_rows"], t["dq_rows"]):
        assert 128 % rows == 0
    for sq in (1, 64, 127, 128, 130, 200, 4000, 4096):
        pad = fa.bwd_scratch_rows(sq)
        assert pad >= sq and pad % 128 == 0 and pad - sq < 128


def _bwd_operands(misalign=None):
    """CPU operands of the backward at dh 64, one of them (by name) made
    to start 2 bytes past a 16-byte boundary."""
    shapes = dict(q=(1, 8, 2, 64), k=(1, 8, 1, 64), v=(1, 8, 1, 64),
                  o=(1, 8, 2, 64), do=(1, 8, 2, 64))
    ops_ = {}
    for name, shape in shapes.items():
        n = int(np.prod(shape))
        if name == misalign:
            ops_[name] = torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1] \
                .view(shape)
        else:
            ops_[name] = torch.zeros(shape, dtype=torch.bfloat16)
    ops_["lse"] = torch.zeros((1, 2, 8), dtype=torch.float32)
    return ops_


@pytest.mark.parametrize("bad,match", [
    ("o", "16 bytes"), ("do", "16 bytes"), ("q", "16 bytes"),
    ("k", "16 bytes"), ("lse_shape", "lse"), ("lse_dtype", "lse")])
def test_bwd_refusals_before_device(bad, match):
    """What the TMA copies and the scratch need is refused on the CPU,
    before the wrapper asks for a CUDA device."""
    from repro_torch.kernels import flash_attention as fa
    x = _bwd_operands(misalign=bad if bad in ("o", "do", "q", "k") else None)
    assert all(t.is_contiguous() for t in x.values())
    if bad == "lse_shape":
        x["lse"] = torch.zeros((1, 2, 9), dtype=torch.float32)
    if bad == "lse_dtype":
        x["lse"] = x["lse"].to(torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_bwd_cuda(x["q"], x["k"], x["v"], x["o"], x["lse"],
                                    x["do"], causal=True)
    ok = _bwd_operands()
    with pytest.raises(ValueError, match="CUDA device"):
        fa.flash_attention_bwd_cuda(ok["q"], ok["k"], ok["v"], ok["o"],
                                    ok["lse"], ok["do"], causal=True)


# ---------------------------------------------------------------------------
# The kernels on the card (no JAX)
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs twin)")
    return torch.device("cuda")


# (name, B, Sq, Sk, H, Hkv, dh, causal, softcap, prefix_len)
CUDA_CASES = [
    ("dh128 causal GQA 12/2", 2, 256, 256, 12, 2, 128, True, 0.0, 0),
    ("dh128 ragged S 200", 1, 200, 200, 4, 4, 128, True, 0.0, 0),
    ("dh64 GQA 25/5", 2, 192, 192, 25, 5, 64, True, 0.0, 0),
    ("dh256 prefix 40 MQA 8/1", 1, 160, 160, 8, 1, 256, True, 0.0, 40),
    ("dh128 softcap 30", 1, 128, 128, 4, 2, 128, True, 30.0, 0),
    ("dh128 Sq 100 < Sk 300", 1, 100, 300, 4, 4, 128, True, 0.0, 0),
    ("dh64 non-causal Sq 70 < Sk 150", 2, 70, 150, 4, 1, 64, False, 0.0, 0),
    # lengths that are multiples of no tile (64 / 128 rows)
    ("dh128 Sq 130 < Sk 200", 1, 130, 200, 4, 2, 128, True, 0.0, 0),
    ("dh64 S 4000 GQA 12/2", 1, 4000, 4000, 12, 2, 64, True, 0.0, 0),
    ("dh128 prefix 300 S 1000", 1, 1000, 1000, 4, 2, 128, True, 0.0, 300),
    ("dh128 group 6 S 1024", 1, 1024, 1024, 12, 2, 128, True, 0.0, 0),
    ("dh128 Hkv = H 8 S 300", 1, 300, 300, 8, 8, 128, True, 0.0, 0),
    ("dh256 non-causal Sq 130 < Sk 200", 1, 130, 200, 4, 2, 256, False, 0.0,
     0),
    ("dh256 softcap 20 S 200", 1, 200, 200, 4, 1, 256, True, 20.0, 0),
    # hubert-xlarge's head_dim: dh 128's tiles over 80 true columns
    ("dh80 non-causal MHA 16 S 200", 1, 200, 200, 16, 16, 80, False, 0.0,
     0),
    ("dh80 causal GQA Sq 130 < Sk 200", 2, 130, 200, 4, 2, 80, True, 0.0,
     0),
    ("dh80 softcap 30 S 300", 1, 300, 300, 4, 4, 80, True, 30.0, 0),
]
BWD_TOL = 1e-2     # max |kernel - twin| over the tensor's max |twin|


def _rel(a, r) -> float:
    return float((a.float() - r.float()).abs().max()
                 / r.float().abs().max().clamp_min(1e-30))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", CUDA_CASES, ids=[c[0] for c in CUDA_CASES])
def test_kernels_match_twins_on_card(cuda, case):
    from repro_torch.kernels import flash_attention as fa
    _, b, sq, sk, h, hkv, dh, causal, softcap, pl = case
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn((b, sq, h, dh), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, sk, hkv, dh), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, sk, hkv, dh), generator=g, device=cuda).bfloat16()
    do = torch.randn((b, sq, h, dh), generator=g, device=cuda).bfloat16()
    mk = dict(causal=causal, softcap=softcap, prefix_len=pl)
    o_plain = fa.flash_attention_cuda(q, k, v, **mk)
    o, lse = fa.flash_attention_cuda(q, k, v, **mk, return_lse=True)
    assert torch.equal(o, o_plain)
    _, lse_t = ref.attention_lse_ref(q.float(), k.float(), v.float(), **mk)
    assert float((lse - lse_t).abs().max()) <= 1e-4
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mk)
    again = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, **mk)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, **mk)
    for name, a, r in zip(("dq", "dk", "dv"), got, want):
        assert a.shape == r.shape and a.dtype == torch.bfloat16
        assert _rel(a, r) <= BWD_TOL, (name, _rel(a, r))


@pytest.mark.requires_cuda
def test_function_on_card_matches_cpu_function(cuda):
    """FlashAttentionFn on CUDA tensors (the two kernels) against the same
    Function on the CPU (the twins), bf16 inputs."""
    q, k, v, do = (torch.from_numpy(x).bfloat16() for x in
                   _inputs(8, 2, 128, 128, 8, 2, 64))
    res = []
    for dev in ("cpu", cuda):
        leaves = [x.detach().to(dev).requires_grad_(True)
                  for x in (q, k, v)]
        out = ops.flash_attention(*leaves, causal=True)
        out.backward(do.to(dev))
        res.append([out.detach().cpu()] + [x.grad.cpu() for x in leaves])
    for name, a, r in zip(("o", "dq", "dk", "dv"), res[1], res[0]):
        assert _rel(a, r) <= BWD_TOL, (name, _rel(a, r))


@pytest.mark.requires_cuda
@pytest.mark.parametrize("fault", ["lse_last_tile", "k_past_diagonal"])
@pytest.mark.parametrize("dh", [64, 80, 128, 256])
def test_kernels_follow_planted_faults(cuda, dh, fault):
    """A planted fault that each kernel must not hide: the LSE of the last
    64-row query tile zeroed (the rows the last dK/dV tile and the last
    dQ block read), or K scaled by 1.5 in the last 128-key tile (past the
    diagonal of every query before it).  On the faulted inputs each of
    dq, dk, dv matches the twin within the tolerance, and lies further
    than the tolerance from the clean result."""
    from repro_torch.kernels import flash_attention as fa
    b, s, h, hkv = 1, 200, 4, 2
    g = torch.Generator(device=cuda).manual_seed(11)
    q = torch.randn((b, s, h, dh), generator=g, device=cuda).bfloat16()
    k = torch.randn((b, s, hkv, dh), generator=g, device=cuda).bfloat16()
    v = torch.randn((b, s, hkv, dh), generator=g, device=cuda).bfloat16()
    do = torch.randn((b, s, h, dh), generator=g, device=cuda).bfloat16()
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    clean = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    if fault == "lse_last_tile":
        lse = lse.clone()
        lse[:, :, (s - 1) // 64 * 64:] = 0.0
    else:
        k = k.clone()
        k[:, (s - 1) // 128 * 128:] = (k[:, (s - 1) // 128 * 128:].float()
                                       * 1.5).bfloat16()
    got = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=True)
    for name, a, r, c in zip(("dq", "dk", "dv"), got, want, clean):
        assert _rel(a, r) <= BWD_TOL, (name, _rel(a, r))
        assert _rel(a, c) > BWD_TOL, (name, _rel(a, c))


@pytest.mark.requires_cuda
def test_kernels_run_from_a_fresh_thread(cuda):
    """The first call of the forward and of the backward in a host thread
    that has not used the card yet (as autograd's backward thread may be)
    encodes its TMA maps and matches the same call on this thread."""
    import threading
    from repro_torch.kernels import flash_attention as fa
    q, k, v, do = (torch.from_numpy(x).bfloat16().to(cuda) for x in
                   _inputs(9, 1, 96, 96, 4, 2, 128))
    o, lse = fa.flash_attention_cuda(q, k, v, causal=True, return_lse=True)
    want = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do, causal=True)
    got = {}

    def run():
        try:
            got["fwd"] = fa.flash_attention_cuda(q, k, v, causal=True,
                                                 return_lse=True)
            got["bwd"] = fa.flash_attention_bwd_cuda(q, k, v, o, lse, do,
                                                     causal=True)
            torch.cuda.synchronize()
        except Exception as e:      # noqa: BLE001 (re-raised below)
            got["error"] = e

    for _ in range(2):              # two fresh threads
        t = threading.Thread(target=run)
        t.start()
        t.join()
        assert "error" not in got, got.get("error")
        assert torch.equal(got["fwd"][0], o)
        assert all(torch.equal(a, b) for a, b in zip(got["bwd"], want))
