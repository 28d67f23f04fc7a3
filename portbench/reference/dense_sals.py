"""Plain PyTorch reference of a dense decoder LM served with SALS.

It imports nothing of the port and takes nothing the port made: from the
benchmark's weights and calibration tokens it fits its own projectors,
and it runs each prompt with its served tokens (teacher forcing) to the
logits of every served position.  Layer equations (Llama / Mistral):
RMSNorm, RoPE (rotate-half), grouped-query attention, SiLU-gated MLP,
untied unembedding.  Matrix products run in the served dtype with f32
accumulation, norms, RoPE, softmax and every attention sum in f32.

Serving semantics it states:

* a prompt is attended exactly (causal);
* a full-precision layer (the first ``skip_layers_front``, the last
  ``skip_layers_back``) attends every earlier position at every decode
  position;
* a SALS layer (paper §4, Algorithm 1) keeps, per position, the latent
  key ``k_pre · U_r`` (U_r: the top-r eigenvectors of the layer's pre-RoPE
  key covariance over the calibration tokens) rounded to ``k_latent_dtype``
  and the value quantized asymmetrically to ``v_bits`` in groups of
  ``v_group`` channels with scale and zero rounded to bf16.  A decode
  query at position t scores every position in [n_sink, t - n_recent] by
  ``q̄[:r*] · k̃[:r*]`` (q̄: the pre-RoPE query summed over each kv group,
  projected by U_r), takes the top n_critical, and attends them with
  keys rebuilt as ``k̃ · U_rᵀ`` and RoPE'd at their own positions and
  values dequantized, beside the first n_sink and the last n_recent
  positions (t included) at full precision.
"""
from __future__ import annotations

import contextlib
from typing import Callable, Dict, List, Optional, Sequence

import torch
import torch.nn.functional as F

from portbench.spec import ModelSpec

BLOCK = 128          # decode queries per block of the attention sums


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    y = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + eps)
    return (y * scale.float()).to(x.dtype)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE in f32.  x (..., n, heads, dh), pos (n,).  Returns
    f32."""
    half = x.shape[-1] // 2
    inv = 1.0 / theta ** (torch.arange(half, dtype=torch.float64,
                                       device=x.device) / half)
    ang = (pos.double()[:, None] * inv).float()
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x32 = x.float()
    x1, x2 = x32[..., :half], x32[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def quantize_values(v: torch.Tensor, bits: int, group: int):
    """(n, c) -> (codes (n, c) f32 in [0, 2^bits - 1], scale (n, c/group)
    f32, zero (n, c/group) f32): min/max per group, half-to-even rounding,
    scale and zero kept at bf16."""
    levels = (1 << bits) - 1
    vg = v.float().reshape(v.shape[0], -1, group)
    lo = vg.amin(-1, keepdim=True)
    scale = ((vg.amax(-1, keepdim=True) - lo) / levels).clamp_min(1e-8)
    codes = torch.round((vg - lo) / scale).clamp(0, levels)
    return (codes.reshape(v.shape),
            scale[..., 0].to(torch.bfloat16).float(),
            lo[..., 0].to(torch.bfloat16).float())


def dequantize_values(codes, scale, zero, group: int) -> torch.Tensor:
    cg = codes.reshape(codes.shape[0], -1, group)
    return (cg * scale[..., None] + zero[..., None]).reshape(codes.shape)


def _sdpa_backends(device: torch.device):
    """Never the materialized path on the card (a 32k prompt would not
    fit)."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    from torch.nn.attention import SDPBackend, sdpa_kernel
    return sdpa_kernel([SDPBackend.FLASH_ATTENTION,
                        SDPBackend.EFFICIENT_ATTENTION])


class DenseSals:
    """The reference for one configuration over the benchmark's weights
    ``w`` (``portbench/weights.py``'s names)."""

    def __init__(self, spec: ModelSpec, w: Dict[str, torch.Tensor],
                 fp8: bool = False):
        """``fp8``: the control's precision, every linear layer's input
        rounded through fp8 e4m3 with one scale a row (the weights are
        handed in rounded, ``weights.fp8_weights``)."""
        self.s = spec
        self.w = w
        self.fp8 = fp8
        self.dev = w["embed"].device
        self.u: Optional[torch.Tensor] = None      # (L, kv_dim, r) f32

    # -- pieces ---------------------------------------------------------------

    def linear(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        if self.fp8:
            scale = x.float().abs().amax(-1, keepdim=True).clamp_min(1e-12) \
                / 448.0
            x = ((x.float() / scale).to(torch.float8_e4m3fn).float()
                 * scale).to(x.dtype)
        return x @ w

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.w["embed"][tokens.long()]
        return x * torch.tensor(self.s.d_model ** 0.5, dtype=x.dtype,
                                device=x.device)

    def qkv(self, x: torch.Tensor, l: int):
        s, w = self.s, self.w
        h = rmsnorm(x, w["attn_norm"][l], s.norm_eps)
        lead = x.shape[:-1]
        q = self.linear(h, w["wq"][l]).reshape(*lead, s.n_heads, s.head_dim)
        k = self.linear(h, w["wk"][l]).reshape(*lead, s.n_kv_heads,
                                                s.head_dim)
        v = self.linear(h, w["wv"][l]).reshape(*lead, s.n_kv_heads,
                                                s.head_dim)
        return q, k, v

    def finish(self, x: torch.Tensor, o: torch.Tensor, l: int
               ) -> torch.Tensor:
        """Output projection, residual, MLP, residual.  o (..., q_dim)."""
        s, w = self.s, self.w
        x = x + self.linear(o.to(x.dtype), w["wo"][l])
        h = rmsnorm(x, w["mlp_norm"][l], s.norm_eps)
        g = F.silu(self.linear(h, w["w_gate"][l])) \
            * self.linear(h, w["w_up"][l])
        return x + self.linear(g, w["w_down"][l])

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        h = rmsnorm(x, self.w["final_norm"], self.s.norm_eps)
        return self.linear(h, self.w["lm_head"]).float()

    def prompt_layer(self, x: torch.Tensor, l: int):
        """One layer over whole prompts x (B, S, d), causal.  Returns (x,
        pre-RoPE k (B, S, Hkv, dh), v)."""
        s = self.s
        q, k, v = self.qkv(x, l)
        pos = torch.arange(x.shape[1], device=x.device)
        dt = x.dtype
        qr = rope(q, pos, s.rope_theta).to(dt).transpose(1, 2)
        kr = rope(k, pos, s.rope_theta).to(dt).transpose(1, 2)
        vt = v.transpose(1, 2)
        kr = kr.repeat_interleave(s.group, dim=1)
        vt = vt.repeat_interleave(s.group, dim=1)
        with _sdpa_backends(x.device):
            a = F.scaled_dot_product_attention(qr, kr, vt, is_causal=True)
        a = a.transpose(1, 2).reshape(*x.shape[:2], s.q_dim)
        return self.finish(x, a, l), k, v

    # -- projectors -------------------------------------------------------------

    @torch.no_grad()
    def fit_projectors(self, cal_tokens: torch.Tensor) -> torch.Tensor:
        """U_r of every SALS layer from the pre-RoPE keys of the
        calibration sequences (B, S): the top-r eigenvectors of Σ kᵀk in
        f64.  Returns (L, kv_dim, r) f32 (full layers' rows zero)."""
        s = self.s
        u = torch.zeros((s.n_layers, s.kv_dim, s.r), dtype=torch.float32,
                        device=self.dev)
        x = self.embed(cal_tokens.to(self.dev))
        for l in range(s.n_layers):
            x, k, _ = self.prompt_layer(x, l)
            if not s.sals_layer(l):
                continue
            kf = k.reshape(-1, s.kv_dim).double()
            vals, vecs = torch.linalg.eigh(kf.T @ kf)
            order = torch.argsort(vals, descending=True)[:s.r]
            u[l] = vecs[:, order].float()
        self.u = u
        return u

    # -- serving ------------------------------------------------------------------

    def latent(self, k: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
        """Latent keys as a SALS layer stores them: pre-RoPE k (n, Hkv,
        dh) times U_r, rounded to ``k_latent_dtype``; (n, r) f32."""
        return (k.reshape(k.shape[0], self.s.kv_dim).float() @ u).to(
            getattr(torch, self.s.sals.k_latent_dtype)).float()

    def stored_values(self, v: torch.Tensor) -> torch.Tensor:
        """Values as a SALS layer stores them, dequantized: (n, kv_dim)
        f32."""
        sl = self.s.sals
        codes, scale, zero = quantize_values(v.reshape(v.shape[0], -1),
                                             sl.v_bits, sl.v_group)
        return dequantize_values(codes, scale, zero, sl.v_group)

    def state(self, l: int, k: torch.Tensor, v: torch.Tensor,
              pos: torch.Tensor) -> Dict[str, torch.Tensor]:
        """What layer ``l``'s cache holds for tokens at positions ``pos``
        (n,) whose pre-RoPE keys and values (n, Hkv, dh) are k, v, each
        field (n, kv_dim) f32: a SALS layer's keys rebuilt from their
        latents (``k_rec``, basis-free), its dequantized values
        (``v_deq``) and, for its recent ring, the keys and values at full
        precision (``k_pre``, ``v``); a full layer's RoPE'd keys
        (``k_rot``) and values (``v``), in the served dtype."""
        s, n = self.s, k.shape[0]
        if s.sals_layer(l):
            u = self.u[l]
            return {"k_rec": self.latent(k, u) @ u.T,
                    "v_deq": self.stored_values(v),
                    "k_pre": k.float().reshape(n, -1),
                    "v": v.float().reshape(n, -1)}
        k_rot = rope(k, pos, s.rope_theta).to(k.dtype)
        return {"k_rot": k_rot.float().reshape(n, -1),
                "v": v.float().reshape(n, -1)}

    def _full_decode(self, q, k_all, v_all, pos):
        """Exact attention of decode queries q (m, H, dh) pre-RoPE at
        positions ``pos`` over every position ≤ its own: k_all pre-RoPE,
        v_all (S, Hkv, dh)."""
        s = self.s
        n = k_all.shape[0]
        kr = rope(k_all.to(q.dtype), torch.arange(n, device=q.device),
                  s.rope_theta)
        vf = v_all.float()
        out = []
        for i in range(0, q.shape[0], BLOCK):
            qb = rope(q[i:i + BLOCK], pos[i:i + BLOCK], s.rope_theta)
            m = qb.shape[0]
            qg = qb.reshape(m, s.n_kv_heads, s.group, s.head_dim)
            lg = torch.einsum("mkgd,nkd->mkgn", qg, kr) * s.head_dim ** -0.5
            ok = torch.arange(n, device=q.device)[None, :] \
                <= pos[i:i + BLOCK, None]
            lg = lg.masked_fill(~ok[:, None, None, :], float("-inf"))
            p = torch.softmax(lg, dim=-1)
            out.append(torch.einsum("mkgn,nkd->mkgd", p, vf)
                       .reshape(m, s.q_dim))
        return torch.cat(out)

    def _sals_decode(self, q, k_all, v_all, pos, u):
        """SALS attention of decode queries q (m, H, dh) pre-RoPE at
        positions ``pos`` over positions 0..S-1 whose pre-RoPE keys and
        values (S, Hkv, dh) are k_all, v_all (see the module docstring)."""
        s, sl = self.s, self.s.sals
        n, dev = k_all.shape[0], q.device
        kvd, dh = s.kv_dim, s.head_dim
        lat = self.latent(k_all, u)
        ar = torch.arange(n, device=dev)
        k_rec = rope((lat @ u.T).reshape(n, s.n_kv_heads, dh), ar,
                     s.rope_theta)
        v_deq = self.stored_values(v_all).reshape(n, s.n_kv_heads, dh)
        k_full = rope(k_all.to(q.dtype), ar, s.rope_theta)
        v_full = v_all.float()
        u_star = u[:, :s.r_star]
        lat_star = lat[:, :s.r_star]
        w = sl.n_recent
        out = []
        for i in range(0, q.shape[0], BLOCK):
            qb, pb = q[i:i + BLOCK], pos[i:i + BLOCK]
            m = qb.shape[0]
            q_bar = qb.float().reshape(m, s.n_kv_heads, s.group, dh) \
                .sum(2).reshape(m, kvd)
            scores = (q_bar @ u_star) @ lat_star.T              # (m, S)
            selectable = (ar[None, :] >= sl.n_sink) \
                & (ar[None, :] <= pb[:, None] - w)
            scores = scores.masked_fill(~selectable, float("-inf"))
            kc = min(sl.n_critical, n)
            top, idx = torch.topk(scores, kc, dim=-1)
            chosen = torch.isfinite(top)
            sink = torch.arange(sl.n_sink, device=dev).expand(m, -1)
            ring = pb[:, None] - torch.remainder(
                pb[:, None] - torch.arange(w, device=dev), w)
            keys = torch.cat([k_full[sink], k_full[ring.clamp_min(0)],
                              k_rec[idx]], dim=1)       # (m, N, Hkv, dh)
            vals = torch.cat([v_full[sink], v_full[ring.clamp_min(0)],
                              v_deq[idx]], dim=1)
            ok = torch.cat([sink <= pb[:, None], ring >= 0, chosen], dim=1)
            qr = rope(qb, pb, s.rope_theta).reshape(m, s.n_kv_heads,
                                                    s.group, dh)
            lg = torch.einsum("mkgd,mnkd->mkgn", qr, keys) * dh ** -0.5
            lg = lg.masked_fill(~ok[:, None, None, :], float("-inf"))
            p = torch.softmax(lg, dim=-1)
            out.append(torch.einsum("mkgn,mnkd->mkgd", p, vals)
                       .reshape(m, s.q_dim))
        return torch.cat(out)

    @torch.no_grad()
    def serve_logits(self, prompt: torch.Tensor,
                     conts: Sequence[torch.Tensor],
                     on_state: Optional[Callable] = None
                     ) -> List[torch.Tensor]:
        """Teacher forcing: for each continuation c (the tokens served
        after ``prompt``), the logits (len(c), V) f32 that predict c[0]
        (at the prompt's last position) .. c[-1].  ``on_state(l, state)``,
        when given, receives layer by layer :meth:`state` of the tokens
        fed for the last continuation (c[:-1], at the positions after the
        prompt)."""
        s = self.s
        if self.u is None:
            raise RuntimeError("fit_projectors first")
        dev = self.dev
        prompt = prompt.to(dev)
        p_len = prompt.shape[0]
        xp = self.embed(prompt)[None]
        xcs = [self.embed(c.to(dev)[:-1]) for c in conts]
        pos_c = [p_len + torch.arange(c.shape[0] - 1, device=dev)
                 for c in conts]
        for l in range(s.n_layers):
            xp, kp, vp = self.prompt_layer(xp, l)
            for j, xc in enumerate(xcs):
                if xc.shape[0] == 0:
                    continue
                q, k, v = self.qkv(xc, l)
                if on_state is not None and j == len(xcs) - 1:
                    on_state(l, self.state(l, k, v, pos_c[j]))
                k_all = torch.cat([kp[0], k])
                v_all = torch.cat([vp[0], v])
                if s.sals_layer(l):
                    o = self._sals_decode(q, k_all, v_all, pos_c[j],
                                          self.u[l])
                else:
                    o = self._full_decode(q, k_all, v_all, pos_c[j])
                xcs[j] = self.finish(xc, o, l)
        last = self.logits(xp[0, -1:])
        return [torch.cat([last, self.logits(xc)]) if xc.shape[0] else last
                for xc in xcs]


Reference = DenseSals
