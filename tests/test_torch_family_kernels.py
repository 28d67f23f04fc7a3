"""The CUDA kernels at the moe and hybrid families' shapes, against their
plain PyTorch twins (``requires_cuda``: they skip without a card; this
file imports no JAX, so ``python -m pytest --noconftest -m requires_cuda
tests/test_torch_family_kernels.py`` runs it on a machine without JAX):

* ``latent_topk`` (row 1) at hymba-1.5b's r 80 / r* 40 and qwen3-moe's
  r 128 / r* 64: exact indices and validity (integer-valued inputs, ties
  included);
* ``sparse_recon_attention`` (row 2) at group 5 with r 80 and dh 64 (25
  heads over 5, hymba: r is not a multiple of the 64-column latent
  stage) and at group 16 with r 128 (64 heads over 4, qwen3-moe): the
  partials within 1e-4 of the twin's, as the kernels' own card tests;
* ``flash_attention`` (row 3) at 25 / 5 heads dh 64 and 64 / 4 heads dh
  128: per-row error within 2^-7 of the row's largest output.

On the CPU the same shapes run the twins (the wrappers' dispatch by
device), which the shape checks below cover without a card."""
import numpy as np
import pytest
import torch

from repro_torch.core import quantization as qz
from repro_torch.kernels import ops

torch.set_num_threads(1)

# (name, B, H, n_kv, dh, S, r, r*, N_c)
SHAPES = {
    "hymba-g5-r80": (2, 25, 5, 64, 300, 80, 40, 48),
    "qwen3-g16-r128": (2, 64, 4, 128, 300, 128, 64, 48),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (kernel vs twin)")
    return torch.device("cuda")


def _topk_inputs(shape, seed):
    b, _, _, _, s, r, r_star, _ = shape
    rng = np.random.default_rng(seed)
    q = torch.from_numpy(rng.integers(-2, 3, (b, r_star)).astype(np.float32))
    k = torch.from_numpy(rng.integers(-2, 3, (b, s, r)).astype(np.float32))
    return q, k.to(torch.bfloat16)


def _sra_inputs(shape, seed):
    b, h, n_kv, dh, s, r, _, n_c = shape
    g = torch.Generator().manual_seed(seed)
    kvd = n_kv * dh
    q = torch.randn((b, h, dh), generator=g).to(torch.bfloat16)
    k_lat = torch.randn((b, s, r), generator=g).to(torch.bfloat16)
    vq = qz.quantize(torch.randn((b, s, kvd), generator=g), 8, 64)
    u = (torch.randn((kvd, r), generator=g) * r ** -0.5).to(torch.bfloat16)
    idx = torch.zeros((b, n_c), dtype=torch.int32)
    valid = torch.zeros((b, n_c), dtype=torch.bool)
    for i, n in enumerate((n_c, n_c // 3)):
        idx[i, :n] = torch.sort(torch.randperm(s - 80, generator=g)[:n]
                                + 16).values.int()
        valid[i, :n] = True
    q_pos = torch.tensor([s - 1, s - 9], dtype=torch.int32)
    return [q, k_lat, None, vq["q"], vq["scale"], vq["zero"], u, idx, valid,
            q_pos]


def _flash_inputs(h, hkv, dh, seed):
    g = torch.Generator().manual_seed(seed)
    return [torch.randn((2, 200, n, dh), generator=g).to(torch.bfloat16)
            for n in (h, hkv, hkv)]


@pytest.mark.parametrize("case", sorted(SHAPES))
def test_twins_run_the_family_shapes(case):
    """The twins (what a CPU tensor takes) at these shapes: the selection
    returns N_c indices of rows that exist, the recon partials are finite
    and the all-valid row has mass."""
    shape = SHAPES[case]
    b, h, n_kv, dh, s, r, r_star, n_c = shape
    q, k = _topk_inputs(shape, 1)
    idx, valid = ops.latent_topk(q, k, None, torch.full((b,), s - 1),
                                 n_critical=n_c, n_sink=16, n_recent=64)
    assert idx.shape == (b, n_c) and bool(valid.all())
    assert int(idx.max()) < s - 64 + 1
    m, l, o = ops.sparse_recon_attention(*_sra_inputs(shape, 2), n_kv=n_kv,
                                         v_bits=8, v_group=64)
    assert o.shape == (b, h, dh) and bool(torch.isfinite(o).all())
    assert bool((l[0] > 0).all())
    qf, kf, vf = _flash_inputs(h, n_kv, dh, 3)
    out = ops.flash_attention(qf.float(), kf.float(), vf.float(),
                              causal=True)
    assert out.shape == qf.shape and bool(torch.isfinite(out).all())


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_latent_topk_kernel_vs_twin_family_shapes(cuda, case):
    shape = SHAPES[case]
    b, s, n_c = shape[0], shape[4], shape[7]
    q, k = _topk_inputs(shape, 4)
    pos = torch.tensor([s - 1, s - 40], dtype=torch.int32)
    kw = dict(n_critical=n_c, n_sink=16, n_recent=64)
    ti, tv = ops.latent_topk(q, k, None, pos, **kw)
    ci, cv = ops.latent_topk(q.to(cuda), k.to(cuda), None, pos.to(cuda),
                             **kw)
    assert torch.equal(cv.cpu(), tv)
    assert torch.equal(ci.cpu(), ti)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("case", sorted(SHAPES))
def test_sparse_recon_attention_kernel_vs_twin_family_shapes(cuda, case):
    shape = SHAPES[case]
    args = _sra_inputs(shape, 5)
    kw = dict(n_kv=shape[2], v_bits=8, v_group=64)
    tm, tl, to = ops.sparse_recon_attention(*args, **kw)
    cm, cl, co = ops.sparse_recon_attention(
        *[None if a is None else a.to(cuda) for a in args], **kw)
    torch.testing.assert_close(cm.cpu(), tm, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(cl.cpu(), tl, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(co.cpu(), to, rtol=1e-4, atol=1e-4)


@pytest.mark.requires_cuda
@pytest.mark.parametrize("h,hkv,dh", [(25, 5, 64), (64, 4, 128)])
def test_flash_attention_kernel_vs_twin_family_shapes(cuda, h, hkv, dh):
    q, k, v = _flash_inputs(h, hkv, dh, 6)
    to = ops.flash_attention(q.float(), k.float(), v.float(), causal=True)
    co = ops.flash_attention(q.to(cuda), k.to(cuda), v.to(cuda),
                             causal=True)
    diff = (co.cpu().float() - to).abs().amax(-1)
    assert float((diff / to.abs().amax(-1)).max()) <= 2.0 ** -7
