"""Gradient compression with error feedback (counterpart of
``repro/optim/compress.py``): symmetric int8 quantization with per-row
scales, the error-feedback step and hot-row pre-aggregation of embedding
gradients (P4DB's offload-the-hot-tuples applied to the gradient path: a
segmented sum over the sorted row stream, the switch engine's ADD path),
and ``compressed_mean``, the mean over a process group with an int8 wire
format (the reference's all-gather inside ``shard_map``).
"""
from __future__ import annotations

import torch


def quantize_int8(x):
    """float32 [..., n] -> (int8 [..., n], float32 scale [..., 1]):
    ``round(x / scale)`` clipped to +-127, ``scale = max(amax, 1e-12) /
    127`` per last-dim row.  ``torch.round`` rounds half to even, as
    ``jnp.round`` does."""
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = amax.clamp_min(1e-12) / 127.0
    q = torch.round(x / scale).clamp_(-127, 127).to(torch.int8)
    return q, scale.float()


def dequantize_int8(q, scale):
    return q.float() * scale


def compressed_mean(x, group, mesh=None):
    """Mean of ``x`` over the ranks of ``group`` (a process group, or the
    name of a dim of ``mesh``, a ``DeviceMesh``) with int8 on the wire:
    quantize locally, ``all_gather_into_tensor`` the int8 payload and the
    float32 scales, dequantize, sum in rank order from rank 0 and divide
    by the rank count — the reference's Python ``sum``, so the result
    equals JAX's bit for bit.

    Wire bytes per device: n*size*1B (+ scales) vs 4*size of an fp32
    all-reduce ring (2x traffic) — a ~6-8x reduction on the pod axis."""
    import torch.distributed as dist
    if isinstance(group, str):
        group = mesh.get_group(group)
    n = dist.get_world_size(group)
    q, s = quantize_int8(x)

    def gather(t):              # the ranks' tensors concatenated on dim 0
        out = t.new_empty((n * t.shape[0],) + tuple(t.shape[1:]))
        dist.all_gather_into_tensor(out, t.contiguous(), group=group)
        return out.view((n,) + tuple(t.shape))

    qs, ss = gather(q), gather(s)                       # int8 on the wire
    return sum(dequantize_int8(qs[i], ss[i]) for i in range(n)) / n


def ef_compress_step(grad, residual):
    """Error feedback: returns (quantized-dequantized grad, new residual)."""
    g = grad + residual
    q, s = quantize_int8(g)
    gq = dequantize_int8(q, s)
    return gq, g - gq


def hot_row_preaggregate(row_ids, row_grads):
    """Aggregate duplicate embedding-row gradients before the collective.

    row_ids: [N] integer (token ids), row_grads: [N, D].  Returns
    (unique_ids [N], agg [N, D], count) with duplicates summed into one
    row per distinct id, in ascending id order; rows past ``count`` are
    zero."""
    order = torch.argsort(row_ids, stable=True)
    ids_s = row_ids[order]
    g_s = row_grads[order]
    first = torch.ones_like(ids_s, dtype=torch.bool)
    first[1:] = ids_s[1:] != ids_s[:-1]                 # segment starts
    seg = torch.cumsum(first, 0) - 1                    # segment per row
    n = row_ids.shape[0]
    agg = torch.zeros_like(g_s).index_add_(0, seg, g_s)
    uniq_ids = torch.zeros(n, dtype=row_ids.dtype,
                           device=row_ids.device).scatter_reduce_(
        0, seg, ids_s, "amax")
    count = first.sum().to(torch.int32)
    return uniq_ids, agg, count
