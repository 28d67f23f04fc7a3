"""Host-side plans of the Hopper kernels, checked on the CPU: which body of
the recon kernel a launch takes, the shared memory it asks for at every
configuration the port serves, and the wrapper checks that refuse, in
Python and before any launch, what the kernels would refuse."""
import pytest
import torch

from repro_torch.config import SALSConfig
from repro_torch.configs import _ARCH_MODULES, get_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import latent_score as ls
from repro_torch.kernels import sparse_recon_attention as sra

LIMIT = 232_448


# ---------------------------------------------------------------------------
# flash attention
# ---------------------------------------------------------------------------

def _flash_args(dh=128, offset=0, sq=8, sk=8, h=4, hkv=2,
                dtype=torch.bfloat16):
    b = 1
    flat = torch.zeros(b * sq * h * dh + offset, dtype=dtype)
    q = flat[offset:].view(b, sq, h, dh)
    kv = torch.zeros((b, sk, hkv, dh), dtype=dtype)
    return q, kv, kv.clone()


@pytest.mark.parametrize("case,kw,match", [
    ("dh96", dict(dh=96), "head_dim"),
    ("misaligned", dict(offset=1), "16 bytes"),
    ("f32", dict(dtype=torch.float32), "bf16"),
    ("kv heads", dict(h=4, hkv=3), "multiple of the kv heads"),
    ("causal Sq > Sk", dict(sq=9, sk=8), "Sq <= Sk"),
    ("valid", {}, "CUDA device"),
])
def test_flash_wrapper_refuses_before_launch(case, kw, match):
    q, k, v = _flash_args(**kw)
    with pytest.raises(ValueError, match=match):
        fa.flash_attention_cuda(q, k, v)


# ---------------------------------------------------------------------------
# sparse recon attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", sorted(_ARCH_MODULES))
@pytest.mark.parametrize("k_dtype", [torch.bfloat16, torch.int8,
                                     torch.float32])
def test_sra_smem_budget_every_config(arch, k_dtype):
    cfg = get_config(arch)
    group = cfg.n_heads // cfg.n_kv_heads
    for sals in (SALSConfig(rank_ratio=0.25, v_bits=8),
                 SALSConfig(rank_ratio=0.125, v_bits=4)):
        r = sals.rank(cfg.kv_dim)
        for ql in range(1, sra.MAX_WINDOW + 1):
            smem = sra.smem_bytes(r, cfg.head_dim, group, ql,
                                  k_dtype=k_dtype, v_bits=sals.v_bits)
            assert smem <= LIMIT, (arch, sals, ql, smem)
            if k_dtype != torch.float32:
                assert sra.ring_stages(cfg.head_dim, group, ql,
                                       sals.v_bits) >= 2


def test_sra_ring_depth_and_rank_independence():
    # the single-token llama2 launch gets a five-stage ring; the
    # widest window (yi-9b, group 8, Q 8) still two
    assert sra.ring_stages(128, 1, 1, 8) == 5
    assert sra.ring_stages(128, 8, 8, 8) == 2
    # the tensor-core body's shared memory does not grow with the rank
    assert sra.smem_bytes(128, 128, 4, 2) == sra.smem_bytes(4096, 128, 4, 2)
    # the CUDA-core body's does (an r x 36 f32 latent tile)
    assert sra.smem_bytes(1024, 128, 1, k_dtype=torch.float32) \
        - sra.smem_bytes(512, 128, 1, k_dtype=torch.float32) == 512 * 36 * 4


def _sra_args(*, r=64, h=4, n_kv=2, dh=64, ql=1, lat_dtype=torch.bfloat16,
              u_dtype=torch.bfloat16, lat_offset=0):
    b, s, n_c = 2, 32, 8
    kvd = n_kv * dh
    q = torch.zeros((b, ql, h, dh), dtype=torch.bfloat16)
    flat = torch.zeros(b * s * r + lat_offset, dtype=lat_dtype)
    k_lat = flat[lat_offset:].view(b, s, r)
    k_scale = torch.ones((b, s), dtype=torch.bfloat16) \
        if lat_dtype == torch.int8 else None
    v_q = torch.zeros((b, s, kvd), dtype=torch.int8)
    v_sz = torch.zeros((b, s, kvd // 64), dtype=torch.bfloat16)
    u = torch.zeros((kvd, r), dtype=u_dtype)
    idx = torch.zeros((b, n_c), dtype=torch.int32)
    valid = torch.zeros((b, n_c), dtype=torch.bool)
    return (q, k_lat, k_scale, v_q, v_sz, v_sz.clone(), u, idx, valid, 0), \
        dict(n_kv=n_kv)


@pytest.mark.parametrize("case,kw,match", [
    ("rank 60", dict(r=60), "multiple of 8"),
    ("misaligned latents", dict(lat_offset=1), "16 bytes"),
    ("window too wide", dict(h=128, n_kv=1, dh=128, ql=8), "ring"),
    ("window of 9", dict(ql=9), "Q <= 8"),
    ("f32 latents, rank too wide", dict(r=4096, lat_dtype=torch.float32),
     "shared memory"),
    ("valid", {}, "CUDA device"),
])
def test_sra_wrapper_refuses_before_launch(case, kw, match):
    args, opts = _sra_args(**kw)
    with pytest.raises(ValueError, match=match):
        sra.sparse_recon_attention_window_cuda(*args, **opts)


@pytest.mark.parametrize("lat_dtype,u_dtype,tensor_cores", [
    (torch.bfloat16, torch.bfloat16, True),
    (torch.int8, torch.bfloat16, True),
    (torch.float32, torch.bfloat16, False),
    (torch.float32, torch.float32, False),
    (torch.int8, torch.float32, False),      # a float32 model's int8 cache
    (torch.bfloat16, torch.float32, False),
])
def test_sra_body_choice(lat_dtype, u_dtype, tensor_cores):
    """bf16 / int8 latents with a bf16 u take the tensor cores; f32 latents
    or an f32 u the CUDA-core body, which takes any rank and needs no
    16-byte alignment: only the device check stops a CPU call."""
    assert sra.tensor_cores(lat_dtype, u_dtype) == tensor_cores
    kw = dict(lat_dtype=lat_dtype, u_dtype=u_dtype)
    if not tensor_cores:
        kw.update(r=60, lat_offset=1)
    args, opts = _sra_args(**kw)
    with pytest.raises(ValueError, match="CUDA device"):
        sra.sparse_recon_attention_window_cuda(*args, **opts)


# ---------------------------------------------------------------------------
# latent score / top-k
# ---------------------------------------------------------------------------

def _latent_args(*, lat_dtype=torch.bfloat16, scale="auto", r=32, r_star=16,
                 transposed=False, q_dtype=torch.float32, paged=False,
                 pt_dtype=torch.int32, pt_batch=2, ps=8):
    b, s = 2, 48
    q_lat = torch.zeros((b, r_star), dtype=q_dtype)
    rows = (7, ps) if paged else (b, s)
    if transposed:
        k_lat = torch.zeros((rows[0], r, rows[1]), dtype=lat_dtype) \
            .transpose(1, 2)
    else:
        k_lat = torch.zeros((*rows, r), dtype=lat_dtype)
    if scale == "auto":
        scale = lat_dtype == torch.int8
    k_scale = torch.ones(rows, dtype=torch.bfloat16) if scale else None
    kw = {}
    if paged:
        kw = dict(page_table=torch.zeros((pt_batch, s // ps),
                                         dtype=pt_dtype),
                  page_size=ps)
    return (q_lat, k_lat, k_scale), kw


_LATENT_CASES = [
    ("f16 latents", dict(lat_dtype=torch.float16), "f32/bf16/int8"),
    ("f64 query", dict(q_dtype=torch.float64), "q_lat must be"),
    ("r* > r", dict(r=16, r_star=24), "exceeds the latent rank"),
    ("non-contiguous latents", dict(transposed=True), "contiguous"),
    ("r* over the query's shared memory", dict(
        r=ls.MAX_R_STAR + 8, r_star=ls.MAX_R_STAR + 8), "r\\* above"),
]


@pytest.mark.parametrize("case,kw,match", _LATENT_CASES + [
    ("int8 without k_scale", dict(lat_dtype=torch.int8, scale=False),
     "int8 latents need k_scale"),
    ("scale with bf16 latents", dict(scale=True), "int8 latents need"),
    ("page table int64", dict(paged=True, pt_dtype=torch.int64),
     "page_table"),
    ("page table batch", dict(paged=True, pt_batch=3), "page_table"),
    ("valid", {}, "CUDA device"),
    ("valid int8 paged", dict(lat_dtype=torch.int8, paged=True),
     "CUDA device"),
    ("valid f32 r* 15 (element loads)", dict(
        lat_dtype=torch.float32, r=33, r_star=15), "CUDA device"),
])
def test_latent_topk_wrapper_refuses_before_launch(case, kw, match):
    args, opts = _latent_args(**kw)
    with pytest.raises(ValueError, match=match):
        ls.latent_topk_cuda(*args, 40, n_critical=8, n_sink=2, n_recent=4,
                            **opts)


@pytest.mark.parametrize("case,kw,match", _LATENT_CASES + [
    ("scale of the wrong shape", dict(lat_dtype=torch.int8, paged=True),
     "k_scale must be"),
    ("valid", {}, "CUDA device"),
    ("valid int8 + scale", dict(lat_dtype=torch.int8), "CUDA device"),
])
def test_latent_score_wrapper_refuses_before_launch(case, kw, match):
    (q_lat, k_lat, k_scale), opts = _latent_args(**kw)
    if opts:     # the plain scores take no pool: a pool's scale shape
        k_lat = torch.zeros((2, 48, k_lat.shape[2]), dtype=k_lat.dtype)
    with pytest.raises(ValueError, match=match):
        ls.latent_score_cuda(q_lat, k_lat, k_scale)


def test_latent_topk_limits():
    """N_c beyond the selection's shared-memory sort is refused; N_c = 0
    and N_c > S reach the device check."""
    args, _ = _latent_args()
    with pytest.raises(ValueError, match="n_critical"):
        ls.latent_topk_cuda(*args, 40, n_critical=ls.MAX_CRITICAL + 1,
                            n_sink=2, n_recent=4)
    for n_c in (0, 100):
        with pytest.raises(ValueError, match="CUDA device"):
            ls.latent_topk_cuda(*args, 40, n_critical=n_c, n_sink=2,
                                n_recent=4)
