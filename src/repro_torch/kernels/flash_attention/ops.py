"""Flash-attention entries: grouping, device dispatch, and the gradient;
and the dense-cache decode.

``flash_attention`` has the signature and layouts of
``repro.kernels.flash_attention.ops.flash_attention``: q (B, Sq, NQ, H),
k/v (B, Skv, NKV, H) -> (B, Sq, NQ, H).  GQA is a query regrouping
(``_group``), never a K/V copy.  The forward runs the plain version
(``ref.flash_fwd``) for a CPU tensor and the CUDA kernel
(``kernel.flash_fwd``) for a CUDA tensor, or raises — there is no
fallback.

The JAX kernel has no backward.  The gradient here is ``flash_backward``,
the plain-PyTorch port of the jnp backward ``_flash_bwd`` of
``repro.models.attention`` (the ``reference`` impl's custom VJP, which
computes the same function): the forward saves ``(q, k, v, out, lse)``
and the backward recomputes the probabilities one KV chunk at a time from
``lse``, so its memory stays flat in the sequence length.  The port's
``reference`` attention uses the same backward.

``flash_decode`` has the signature of
``repro.kernels.flash_attention.ops.flash_decode`` (no ``block_kv`` or
``interpret``: the CUDA kernel picks its own tiles): one query token
against a whole K/V cache with a valid length a row.  It also takes a
length a query, (B, Sq), which is how the model's dense-cache decode
runs a prefill chunk through it.  A CPU tensor runs the plain version
(``ref.flash_decode``), a CUDA tensor the kernel (``kernel.flash_decode``)
or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels.common import aligned
from repro_torch.kernels.flash_attention import kernel as K
from repro_torch.kernels.flash_attention import ref

NEG_INF = ref.NEG_INF
BWD_KV_CHUNK = 1024          # KV rows per chunk of the backward


def _group(q, k, v):
    """(B,S,N,H)-layout -> q (B*NKV, G*Sq, H), k/v (B*NKV, Skv, H).

    Grouped q row ``r`` is query head ``g = r // Sq`` at column
    ``r % Sq``; global head order is ``n = kv * G + g``, so the output
    reshapes straight back."""
    B, Sq, NQ, H = q.shape
    NKV = k.shape[2]
    G = NQ // NKV
    qg = q.reshape(B, Sq, NKV, G, H).permute(0, 2, 3, 1, 4)
    qg = qg.reshape(B * NKV, G * Sq, H)
    kg = k.transpose(1, 2).reshape(B * NKV, -1, H)
    vg = v.transpose(1, 2).reshape(B * NKV, -1, H)
    return qg, kg, vg, (B, NKV, G, Sq, H)


def _ungroup(out, dims):
    B, NKV, G, Sq, H = dims
    out = out.reshape(B, NKV, G, Sq, H)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, NKV * G, H)


def flash_fwd(qg, kg, vg, *, causal: bool, softcap: float, sq_real: int):
    """Grouped forward -> ``(out, lse)``: the plain version for a CPU
    tensor, the kernel for any other (which raises off a Hopper card)."""
    if qg.device.type == "cpu":
        return ref.flash_fwd(qg, kg, vg, causal=causal, softcap=softcap,
                             sq_real=sq_real)
    return K.flash_fwd(aligned(qg), aligned(kg), aligned(vg),
                       causal=causal, softcap=softcap, sq_real=sq_real)


def flash_backward(q, k, v, out, lse, dout, *, causal: bool, softcap: float,
                   sq_real: int = 0, skv_real: int = 0,
                   kv_chunk: int = BWD_KV_CHUNK):
    """Gradients of the grouped flash forward: q/out/dout (BN, R, H), k/v
    (BN, Skv, H), ``lse`` (BN, R) fp32; row r is query column
    ``r % sq_real``; keys at or past ``skv_real`` (0: Skv) are padding.

    Per KV chunk: ``p = exp(mask(softcap(s)) - lse)``, ``D =
    rowsum(dout * out)``, ``ds = p (dP - D)`` times the softcap
    derivative ``1 - (sc / softcap)^2``, masked.  Chunks wholly above the
    causal diagonal are skipped.  Math in fp32; the
    gradients come back in the inputs' dtypes."""
    BN, R, H = q.shape
    Skv = k.shape[1]
    sq = sq_real or R
    skv = skv_real or Skv
    scale = H ** -0.5
    qf, do = q.float(), dout.float()
    D = (do * out.float()).sum(-1, keepdim=True)             # (BN, R, 1)
    q_pos = (torch.arange(R, device=q.device) % sq)[:, None]
    dq = torch.zeros((BN, R, H), dtype=torch.float32, device=q.device)
    dk = torch.zeros((BN, Skv, H), dtype=torch.float32, device=q.device)
    dv = torch.zeros((BN, Skv, H), dtype=torch.float32, device=q.device)
    for lo in range(0, Skv, kv_chunk):
        if causal and lo > sq - 1:
            break                          # every later chunk is above too
        hi = min(lo + kv_chunk, Skv)
        kc, vc = k[:, lo:hi].float(), v[:, lo:hi].float()
        s = torch.bmm(qf, kc.transpose(1, 2)) * scale         # (BN, R, Ck)
        if softcap:
            sc = softcap * torch.tanh(s / softcap)
            dsc_ds = 1.0 - torch.square(sc / softcap)
        else:
            sc, dsc_ds = s, None
        kv_pos = torch.arange(lo, hi, device=q.device)[None, :]
        mask = kv_pos < skv
        if causal:
            mask = mask & (kv_pos <= q_pos)
        sc = torch.where(mask, sc, NEG_INF)
        p = torch.exp(sc - lse[..., None])
        dv[:, lo:hi] = torch.bmm(p.transpose(1, 2), do)
        dp = torch.bmm(do, vc.transpose(1, 2))
        ds = p * (dp - D)
        if dsc_ds is not None:
            ds = ds * dsc_ds
        ds = torch.where(mask, ds, 0.0)
        dq += torch.bmm(ds, kc) * scale
        dk[:, lo:hi] = torch.bmm(ds.transpose(1, 2), qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


PROFILE_RANGE = "flash_plain_backward"


class FlashAttention(torch.autograd.Function):
    """The grouped flash forward (kernel on the card, plain version on the
    CPU) with ``flash_backward`` as its gradient."""

    @staticmethod
    def forward(ctx, qg, kg, vg, causal, softcap, sq_real):
        out, lse = flash_fwd(qg, kg, vg, causal=causal, softcap=softcap,
                             sq_real=sq_real)
        ctx.save_for_backward(qg, kg, vg, out, lse)
        ctx.opts = (causal, softcap, sq_real)
        return out

    @staticmethod
    def backward(ctx, dout):
        causal, softcap, sq_real = ctx.opts
        # the range names this backward's device time under torch.profiler
        with torch.profiler.record_function(PROFILE_RANGE):
            dq, dk, dv = flash_backward(*ctx.saved_tensors, dout,
                                        causal=causal, softcap=softcap,
                                        sq_real=sq_real)
        return dq, dk, dv, None, None, None


def flash_attention(q, k, v, *, causal: bool = True, softcap: float = 0.0):
    """q: (B, Sq, NQ, H); k/v: (B, Skv, NKV, H) -> (B, Sq, NQ, H) in
    q's dtype; differentiable in q, k and v."""
    qg, kg, vg, dims = _group(q, k, v)
    out = FlashAttention.apply(qg, kg, vg, causal, float(softcap), dims[3])
    return _ungroup(out, dims)


def flash_decode(q, k, v, kv_valid, *, softcap: float = 0.0):
    """q: (B, Sq, NQ, H) (Sq 1 in the JAX op); k/v cache: (B, S, NKV, H);
    kv_valid: (B,) or (B, Sq) valid lengths.  Returns (B, Sq, NQ, H) in
    q's dtype; a query with no valid key is all zero."""
    if q.device.type == "cpu":
        return ref.flash_decode(q, k, v, kv_valid, softcap=softcap)
    B, Sq = q.shape[:2]
    lens = kv_valid.to(torch.int32).reshape(B, -1).expand(B, Sq)
    return K.flash_decode(q.contiguous(), k, v, lens.contiguous(),
                          softcap=float(softcap))
