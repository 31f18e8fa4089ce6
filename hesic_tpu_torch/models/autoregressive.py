"""The autoregressive weights of the AR codecs, and the host AR coding
paths.

Counterpart of hesic_tpu/models/autoregressive.py.  ``ArWeights`` and
``extract_ar_weights`` pull the weights out of a model in the JAX
package's layouts: the context kernel HWIO (5, 5, M, 2M) with the
causality mask applied, and the 1x1 entropy-parameter kernels as (Cin,
Cout) matrices, all float32 (the wavefront and the host coder compute
their parameters in float32 whatever the transforms' compute type).

The host paths run the raster-causal recursion in the native coder
(codecs/host_rans.py ``ar_code``), one float implementation shared by
encode and decode, so the Gaussian parameters that index the CDF tables
are bit-identical on both sides.  ``ar_compress``/``ar_decompress`` code
a batch's images on a thread pool (the native call releases the GIL).
The transforms stay on the codec's device: the coder is handed NHWC
float32 contiguous host arrays of ``pre`` (the hyper-synthesis output),
``post`` (an optional extra conditioning map: HESIC+ feeds the
re-encoded decoded-left latent there) and ``y``, and y_hat goes back
up through ``CompressionModel._upload``.  ``ar_decompress_reference``
(a numpy row decoder over the stateful ``RansDecoder``) and
``ar_encode_scan`` (a plain torch loop over positions) are independent
cross-checks of the native coder.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..entropy_models import build_indexes
from .hesic_plus import stack_names

_PAD = 2  # the context kernel is 5x5


class ArWeights(NamedTuple):
    """Context + entropy-parameter weights."""

    ctx_kernel: torch.Tensor  # (5, 5, M, 2M), causality mask applied
    ctx_bias: torch.Tensor    # (2M,)
    ep_kernels: tuple         # three (Cin, Cout) 1x1 kernels
    ep_biases: tuple


def extract_ar_weights(model: torch.nn.Module,
                       ctx_name: str = "context_prediction",
                       ep_prefix: str = "entropy_parameters") -> ArWeights:
    """The autoregressive weights of `model`'s ``ctx_name`` masked conv
    and its three ``{ep_prefix}_{0,2,4}`` 1x1 convs."""
    ctx = getattr(model, ctx_name)
    eps = [getattr(model, n) for n in stack_names(ep_prefix)]
    return ArWeights(
        ctx_kernel=ctx.masked_weight().detach().float().permute(
            2, 3, 1, 0).contiguous(),
        ctx_bias=ctx.bias.detach().float().contiguous(),
        ep_kernels=tuple(e.weight.detach().float()[:, :, 0, 0].t()
                         .contiguous() for e in eps),
        ep_biases=tuple(e.bias.detach().float().contiguous() for e in eps),
    )


def _ep_mlp(feat: torch.Tensor, w: ArWeights) -> torch.Tensor:
    """The entropy-parameter stack as a per-pixel MLP, leaky slope 0.01."""
    g = F.leaky_relu(feat @ w.ep_kernels[0] + w.ep_biases[0], 0.01)
    g = F.leaky_relu(g @ w.ep_kernels[1] + w.ep_biases[1], 0.01)
    return g @ w.ep_kernels[2] + w.ep_biases[2]


@torch.no_grad()
def ar_encode_scan(w: ArWeights, y: torch.Tensor, pre: torch.Tensor,
                   post, scale_table):
    """The raster recursion as a plain loop over positions, on y's device:
    y (B, M, H, W), pre (B, P, H, W), post (B, Q, H, W) or None ->
    (symbols, indexes int32, y_hat float32), all (B, M, H, W).  A
    cross-check of the native coder, not a codec path."""
    b, m, h, w_dim = y.shape
    y_pad = torch.zeros(b, m, h + 2 * _PAD, w_dim + 2 * _PAD,
                        dtype=torch.float32, device=y.device)
    symbols = torch.empty(b, m, h, w_dim, dtype=torch.int32,
                          device=y.device)
    indexes = torch.empty_like(symbols)
    parts = [pre.float()] + ([] if post is None else [post.float()])
    for hh in range(h):
        for ww in range(w_dim):
            crop = y_pad[:, :, hh:hh + 2 * _PAD + 1, ww:ww + 2 * _PAD + 1]
            ctx = torch.einsum("bcij,ijco->bo", crop,
                               w.ctx_kernel) + w.ctx_bias
            feat = torch.cat([parts[0][:, :, hh, ww], ctx]
                             + [p[:, :, hh, ww] for p in parts[1:]], dim=1)
            scales, means = _ep_mlp(feat, w).chunk(2, dim=1)
            y_q = torch.round(y[:, :, hh, ww].float() - means)
            y_pad[:, :, hh + _PAD, ww + _PAD] = y_q + means
            symbols[:, :, hh, ww] = y_q.to(torch.int32)
            indexes[:, :, hh, ww] = build_indexes(scales, scale_table)
    return symbols, indexes, y_pad[:, :, _PAD:-_PAD, _PAD:-_PAD].contiguous()


def host_threads(n: int) -> int:
    """The width of the pool that codes `n` images: one thread an image,
    at most one a host core."""
    return max(1, min(n, os.cpu_count() or 4))


def _batch_parallel(fn, n: int) -> list:
    """[fn(0), ..., fn(n - 1)], on a thread pool when n > 1 (the native
    coder releases the GIL, so threads scale across the host's cores)."""
    if n <= 1:
        return [fn(i) for i in range(n)]
    with ThreadPoolExecutor(host_threads(n)) as ex:
        return list(ex.map(fn, range(n)))


def _native_weights(codec, ctx_name: str, ep_prefix: str):
    """`codec`'s AR weights and scale table as the native coder's host
    arrays, built from the model at each call, so a codec whose model
    was trained further (then ``update(force=True)``) codes with the
    weights a fresh codec would use."""
    from ..codecs.host_rans import ArWeightsNative
    w = extract_ar_weights(codec.model, ctx_name, ep_prefix)
    return ArWeightsNative(
        w.ctx_kernel.cpu().numpy(), w.ctx_bias.cpu().numpy(),
        [k.cpu().numpy() for k in w.ep_kernels],
        [bv.cpu().numpy() for bv in w.ep_biases], codec.scale_table)


def _host_nhwc(t) -> np.ndarray:
    """A (B, C, H, W) tensor (any float dtype) -> (B, H, W, C) float32
    contiguous host array."""
    return np.ascontiguousarray(
        t.detach().float().permute(0, 2, 3, 1).cpu().numpy())


def _upload_nchw(codec, y_hat: np.ndarray) -> torch.Tensor:
    """(B, H, W, M) host y_hat -> (B, M, H, W) contiguous on the codec
    device."""
    return codec._upload(y_hat).permute(0, 3, 1, 2).contiguous()


def ar_compress(codec, y, pre, post=None,
                ctx_name: str = "context_prediction",
                ep_prefix: str = "entropy_parameters",
                gc_name: str = "gaussian_conditional"):
    """Autoregressive encode in the native coder: y (B, M, H, W), pre
    (B, P, H, W), post (B, Q, H, W) or None, on the codec device ->
    (one string per image, y_hat (B, M, H, W) float32 on the codec
    device).  y_hat is the decoder's exactly: a later stage that
    conditions on the decoded latent must use it."""
    from ..codecs.host_rans import ar_code
    weights = _native_weights(codec, ctx_name, ep_prefix)
    tables = codec.tables[gc_name]
    pre_h, y_h = _host_nhwc(pre), _host_nhwc(y)
    post_h = None if post is None else _host_nhwc(post)
    outs = _batch_parallel(
        lambda i: ar_code(0, weights, pre_h[i],
                          None if post_h is None else post_h[i], tables,
                          y=y_h[i]),
        y_h.shape[0])
    return ([o[0] for o in outs],
            _upload_nchw(codec, np.stack([o[1] for o in outs])))


def ar_decompress(codec, y_strings: list, pre, post=None,
                  ctx_name: str = "context_prediction",
                  ep_prefix: str = "entropy_parameters",
                  gc_name: str = "gaussian_conditional") -> torch.Tensor:
    """Autoregressive decode in the native coder (pairs with
    ar_compress: the same float math) -> y_hat (B, M, H, W) float32 on
    the codec device."""
    from ..codecs.host_rans import ar_code
    weights = _native_weights(codec, ctx_name, ep_prefix)
    tables = codec.tables[gc_name]
    pre_h = _host_nhwc(pre)
    post_h = None if post is None else _host_nhwc(post)
    outs = _batch_parallel(
        lambda i: ar_code(1, weights, pre_h[i],
                          None if post_h is None else post_h[i], tables,
                          stream=y_strings[i]),
        len(y_strings))
    return _upload_nchw(codec, np.stack(outs))


def ar_decompress_reference(codec, y_strings: list, pre, post=None,
                            ctx_name: str = "context_prediction",
                            ep_prefix: str = "entropy_parameters",
                            gc_name: str = "gaussian_conditional"
                            ) -> torch.Tensor:
    """Row-pipelined numpy decoder over the stateful RansDecoder, an
    independent cross-check of the native coder: each row's upper
    context is one (W, 10M) x (10M, 2M) product, the two left taps and
    the MLP run per pixel.  pre (B, P, H, W), post (B, Q, H, W) or None
    -> y_hat (B, M, H, W) float32 on the codec device."""
    from ..codecs.host_rans import RansDecoder
    w = extract_ar_weights(codec.model, ctx_name, ep_prefix)
    ctx_k = w.ctx_kernel.cpu().numpy()                  # (5, 5, M, 2M)
    ctx_b = w.ctx_bias.cpu().numpy()
    ep_ks = [k.cpu().numpy() for k in w.ep_kernels]
    ep_bs = [bv.cpu().numpy() for bv in w.ep_biases]
    table = np.asarray(codec.scale_table, np.float32)
    thresholds = table[:-1]
    tables = codec.tables[gc_name]
    cdf, cdf_len, offsets = (tables.quantized_cdf, tables.cdf_length,
                             tables.offset)
    pre = _host_nhwc(pre)
    b, h, w_dim, _ = pre.shape
    m = ctx_k.shape[2]
    post = (np.zeros((b, h, w_dim, 0), np.float32) if post is None
            else _host_nhwc(post))
    k_up = ctx_k[:_PAD].reshape(_PAD * 5 * m, 2 * m)    # (10M, 2M)
    k_left2, k_left1 = ctx_k[_PAD, 0], ctx_k[_PAD, 1]   # (M, 2M) each

    def leaky(v):
        return np.where(v >= 0, v, 0.01 * v)

    y_hat = np.zeros((b, h + 2 * _PAD, w_dim + 2 * _PAD, m), np.float32)
    dec = RansDecoder()
    for i in range(b):
        dec.set_stream(y_strings[i])
        for hh in range(h):
            windows = np.lib.stride_tricks.sliding_window_view(
                y_hat[i, hh:hh + _PAD], 5, axis=1)      # (2, W, M, 5)
            ctx_up = windows.transpose(1, 0, 3, 2).reshape(
                w_dim, _PAD * 5 * m) @ k_up             # (W, 2M)
            row = y_hat[i, hh + _PAD]                   # (W+4, M) view
            for ww in range(w_dim):
                ctx = (ctx_up[ww] + row[ww] @ k_left2 + row[ww + 1] @ k_left1
                       + ctx_b)
                feat = np.concatenate([pre[i, hh, ww], ctx, post[i, hh, ww]])
                g = leaky(feat @ ep_ks[0] + ep_bs[0])
                g = leaky(g @ ep_ks[1] + ep_bs[1])
                g = g @ ep_ks[2] + ep_bs[2]
                scales = np.maximum(g[:m], table[0])
                idx = (scales[:, None] > thresholds).sum(axis=1)
                rv = dec.decode_stream(idx.astype(np.int32), cdf, cdf_len,
                                       offsets)
                row[ww + _PAD] = rv.astype(np.float32) + g[m:]
    return _upload_nchw(codec, np.ascontiguousarray(
        y_hat[:, _PAD:-_PAD, _PAD:-_PAD]))
