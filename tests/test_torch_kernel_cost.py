"""``kernels/cost.py`` and the kernel wrappers' meta branch and work records
(no JAX: the reference has no counterpart of either).

* every ``ops`` wrapper on meta tensors returns the twin's output shapes
  and dtypes (the twin run on the CPU at a small size on the same
  shapes), launches nothing, and records its work function's (flops,
  bytes) once;
* a CPU call under ``analysis.analyze_step`` counts that work once, and
  none of the twin's own ops;
* the work functions give the bounds of ``PERF.md``'s kernel table at the
  cases behind it (rows 1, 2, 3, 3b and 8: ``chip_smoke.py``'s main
  cases, the data-dependent counts as those runs had them), equal to the
  formulas ``chip_smoke.py`` computed them with before they moved here;
* ``attended_pairs``'s closed form equals the row-by-row count.
"""
import pytest
import torch

from repro_torch.analysis import analyze_step
from repro_torch.analysis.roofline import F32_PEAK_FLOPS, HBM_BW, PEAK_FLOPS
from repro_torch.core import quantization as qz
from repro_torch.kernels import cost, ops


def _inputs(device, seed=0):
    """One small operand set per wrapper: (name, call, work)."""
    g = torch.Generator().manual_seed(seed)

    def rn(*shape, dtype=torch.float32):
        return torch.randn(shape, generator=g).to(dtype).to(device)

    b, s, r, r_star, n_c, h, n_kv, dh = 2, 64, 16, 8, 12, 4, 2, 16
    kvd = n_kv * dh
    q_lat, k_lat = rn(b, r_star), rn(b, s, r)
    pos = torch.tensor([63, 40], dtype=torch.int32).to(device)
    base = torch.tensor([60, 37], dtype=torch.int32).to(device)
    vq = qz.quantize(torch.randn((b, s, kvd), generator=g), 8, 16)
    v = tuple(vq[k].to(device) for k in ("q", "scale", "zero"))
    u = rn(kvd, r)
    idx = torch.stack([torch.arange(n_c), torch.arange(n_c) + 5]).to(
        torch.int32).to(device)
    valid = torch.ones((b, n_c), dtype=torch.bool).to(device)
    ps = 16
    page_table = torch.arange(b * s // ps, dtype=torch.int32).reshape(
        b, s // ps).flip(1).contiguous().to(device)
    pools = tuple(t.reshape(b * s // ps, ps, *t.shape[2:])
                  for t in (k_lat, *v))
    q1, qw = rn(b, h, dh), rn(b, 3, h, dh)
    fq, fk, fv = rn(b, 32, h, dh), rn(b, 32, n_kv, dh), rn(b, 32, n_kv, dh)
    tk = dict(n_critical=n_c, n_sink=2, n_recent=4)
    rk = dict(n_kv=n_kv, v_group=16)
    pg = dict(page_table=page_table, page_size=ps)
    return [
        ("flash_attention",
         lambda: ops.flash_attention(fq, fk, fv, causal=True),
         cost.flash_work(fq, fk, fv, causal=True)),
        ("latent_score", lambda: ops.latent_score(q_lat, k_lat),
         cost.latent_score_work(q_lat, k_lat)),
        ("latent_topk", lambda: ops.latent_topk(q_lat, k_lat, None, pos,
                                                **tk),
         cost.latent_topk_work(q_lat, k_lat, None, pos, n_critical=n_c)),
        ("latent_topk_paged", lambda: ops.latent_topk(
            q_lat, pools[0], None, pos, **tk, **pg),
         cost.latent_topk_work(q_lat, pools[0], None, pos, n_critical=n_c,
                               **pg)),
        ("sparse_recon_attention", lambda: ops.sparse_recon_attention(
            q1, k_lat, None, *v, u, idx, valid, pos, **rk),
         cost.recon_work(q1, k_lat, None, *v, u, idx, valid, pos,
                         n_kv=n_kv)),
        ("sparse_recon_attention_paged", lambda: ops.sparse_recon_attention(
            q1, pools[0], None, *pools[1:], u, idx, valid, pos, **rk, **pg),
         cost.recon_work(q1, pools[0], None, *pools[1:], u, idx, valid, pos,
                         n_kv=n_kv, **pg)),
        ("sparse_recon_attention_window",
         lambda: ops.sparse_recon_attention_window(
             qw, k_lat, None, *v, u, idx, valid, base, n_recent=4, **rk),
         cost.recon_work(qw, k_lat, None, *v, u, idx, valid, pos,
                         n_kv=n_kv)),
        ("sparse_recon_attention_window_paged",
         lambda: ops.sparse_recon_attention_window(
             qw, pools[0], None, *pools[1:], u, idx, valid, base,
             n_recent=4, **rk, **pg),
         cost.recon_work(qw, pools[0], None, *pools[1:], u, idx, valid, pos,
                         n_kv=n_kv, **pg)),
    ]


def _shapes(out):
    out = out if isinstance(out, tuple) else (out,)
    return [(tuple(t.shape), t.dtype) for t in out]


@pytest.mark.parametrize("i", range(8))
def test_meta_call_returns_twin_shapes_and_records_work(i):
    name, call_cpu, work = _inputs("cpu")[i]
    want = _shapes(call_cpu())
    m_name, call_meta, m_work = _inputs("meta")[i]
    before = ops.launch_counts()
    with cost.counting() as c:
        got = call_meta()
    assert all(t.device.type == "meta" for t in
               (got if isinstance(got, tuple) else (got,)))
    assert _shapes(got) == want
    assert ops.launch_counts() == before
    assert m_work == work
    assert c.by_kernel == {name: [1, work[0], work[1]]}


def test_flash_grad_meta_records_forward_and_backward():
    """FlashAttentionFn on meta tensors: O and the gradients at the
    inputs' shapes, the forward's work with its LSE, then the backward's."""
    q, k, v = (torch.empty(s, device="meta", requires_grad=True)
               for s in ((2, 64, 4, 16), (2, 64, 2, 16), (2, 64, 2, 16)))
    with cost.counting() as c:
        o = ops.flash_attention(q, k, v)
        dq, dk, dv = torch.autograd.grad(o, (q, k, v), torch.empty_like(o))
    assert o.shape == q.shape and o.device.type == "meta"
    assert [t.shape for t in (dq, dk, dv)] == [q.shape, k.shape, v.shape]
    lse = torch.empty((2, 4, 64), device="meta")
    assert c.by_kernel == {
        "flash_attention": [1, *cost.flash_work(q, k, v, lse=True)],
        "flash_attention_bwd": [1, *cost.flash_bwd_work(q, k, v, o, lse,
                                                        o)]}


@pytest.mark.parametrize("i", range(8))
def test_cpu_call_counts_the_work_once_not_the_twin(i):
    name, call, work = _inputs("cpu")[i]
    rep, _ = analyze_step(call)
    assert rep.ops == {name: [1, work[0], work[1]]}
    assert (rep.flops, rep.bytes_accessed) == (work[0], work[1])


def test_nothing_recorded_without_a_counter():
    name, call, work = _inputs("cpu")[0]
    with cost.counting() as outer:
        pass
    call()
    assert outer.by_kernel == {} and not cost.in_kernel()


def _bound_ms(flops, nbytes, peak):
    return max(nbytes / HBM_BW, flops / peak) * 1e3


def _meta(shape, dtype=torch.bfloat16):
    return torch.empty(shape, dtype=dtype, device="meta")


def test_work_equals_chip_smoke_bounds_of_the_kernel_table():
    # row 1: latent_topk, llama2-7b B4 S4160 r1024 r*512 N_c 432 bf16, the
    # 12,992 selectable rows of chip_smoke's ragged positions
    b, s, r, rs, nc, n_sel = 4, 4160, 1024, 512, 432, 12992
    got = cost.latent_topk_work(_meta((b, rs), torch.float32),
                                _meta((b, s, r)), None, None, n_critical=nc,
                                selectable_rows=n_sel)
    old = (2.0 * n_sel * rs,
           b * rs * 4 + n_sel * rs * 2 + 2 * b * 4 + b * nc * 5)
    assert got == old
    assert round(_bound_ms(*got, F32_PEAK_FLOPS), 4) == 0.0040
    # row 2: sparse_recon_attention, llama2-7b B4 H32 dh128 r1024 int8-V,
    # 1,008 valid rows (432, 432, 144, 0)
    h, n_kv, dh, nv = 32, 32, 128, 1008
    kvd = n_kv * dh
    vq = _meta((b, s, kvd), torch.int8)
    grp = _meta((b, s, kvd // 64))
    got = cost.recon_work(_meta((b, h, dh)), _meta((b, s, r)), None, vq,
                          grp, grp, _meta((kvd, r)),
                          _meta((b, nc), torch.int32),
                          _meta((b, nc), torch.bool), None, n_kv=n_kv,
                          valid_rows=nv)
    row_bytes = r * 2 + kvd + 2 * 2 * (kvd // 64)
    old = (2.0 * nv * kvd * r + 4.0 * nv * (h // n_kv) * kvd,
           b * h * dh * 2 + nv * row_bytes + kvd * r * 2 + b * nc * 5
           + b * 4 + b * h * (2 + dh) * 4)
    assert got == old
    assert round(_bound_ms(*got, PEAK_FLOPS), 4) == 0.0086
    # row 3: flash_attention, llama2-7b B4 S4096 H32 dh128 causal
    q = _meta((4, 4096, 32, 128))
    got = cost.flash_work(q, q, q, causal=True)
    pairs = sum(min(4096, i + 1) for i in range(4096))
    assert got == (4.0 * 4 * 32 * 128 * pairs, 2 * (2 * q.numel()
                                                     + 2 * q.numel()))
    assert round(_bound_ms(*got, PEAK_FLOPS), 3) == 0.556
    # row 3b: the flash backward at qwen2-1.5b's B4 S4096 12 / 2 dh128
    q, kv = _meta((4, 4096, 12, 128)), _meta((4, 4096, 2, 128))
    lse = _meta((4, 12, 4096), torch.float32)
    got = cost.flash_bwd_work(q, kv, kv, q, lse, q, causal=True)
    assert got == (10.0 * 4 * 12 * 128 * pairs,
                   2 * (4 * q.numel() + 4 * kv.numel()) + 4 * lse.numel())
    assert round(_bound_ms(*got, PEAK_FLOPS), 3) == 0.521
    # row 8: latent_score, the overlap path's f32 B2 S4096 r1024 r*512
    got = cost.latent_score_work(_meta((2, 512), torch.float32),
                                 _meta((2, 4096, 1024), torch.float32))
    assert got == (2.0 * 2 * 4096 * 512,
                   2 * 512 * 4 + 2 * 4096 * 512 * 4 + 2 * 4096 * 4)
    assert round(_bound_ms(*got, F32_PEAK_FLOPS), 4) == 0.0050


@pytest.mark.parametrize("sq,sk,causal,prefix", [
    (64, 64, True, 0), (10, 30, True, 0), (30, 30, True, 40),
    (16, 48, True, 40), (16, 48, True, 20), (7, 7, False, 0),
    (100, 300, True, 256), (1, 9, True, 0)])
def test_attended_pairs_closed_form(sq, sk, causal, prefix):
    off = sk - sq
    want = sum(max(min(sk, off + i + 1), min(sk, prefix))
               for i in range(sq)) if causal else sq * sk
    assert cost.attended_pairs(sq, sk, causal, prefix) == want
