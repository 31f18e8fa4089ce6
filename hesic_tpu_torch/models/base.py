"""Host-side model wrapper: a model + the integer coder tables.

Counterpart of the parts of hesic_tpu/models/base.py that the codecs
use: ``update()`` builds the EntropyBottleneck CDF tables and, for a
model with Gaussian conditionals, the scale table and the Gaussian CDF
tables; ``tables`` holds them, ``eb_medians`` gives the z symbol
offsets.  Two z codings: ``eb_encode_symbols``/``eb_decode_streams``
code (B, zh, zw, C) symbols in NHWC order, as the fast codec's z path
does (hesic_tpu/models/hesic_fast.py); ``eb_compress``/``eb_decompress``
code them channel-major, the reference's NCHW flatten order, as the JAX
package's host codecs do.  ``gc_compress``/``gc_decompress`` code y
through the Gaussian tables, channel-major, given scale-table indexes.
The input helpers move the caller's NHWC images and homographies to the
model's device (on the card through pinned memory, without blocking the
host).  ``deterministic_backends`` is the codecs' shared determinism
policy.  ``counted_flops`` runs a program under PyTorch's FLOP counter
(the codecs' ``device_flops``).  ``TogetherCodec`` is the codec of the
stage-2 models: an inner codec, then the enhancement.

The device codecs' shared parts.  ``PipelinedCodec`` is the fast codecs'
pipelined serving protocol (``compress_fast``, ``compress_fast_start``,
``compress_fast_finish``, ``decompress_fast_batch``; the side streams,
the pinned fetch, the words' copy on the finish stream, the sequence
numbers), which HESIC's and DSIC's ``HESICFastCodec`` and HESIC+'s
``HESICPlusDeviceCodec`` inherit.  The container pieces are module
functions: the escape record (``escape_record``/``read_escape_record``),
length-prefixed strings (``length_prefixed``/``prefixed_extents``), the
decoder's one pinned upload (``pack_parts``/``split_parts``), the u16
cast (``u16``), the lane-major word rebuild (``expand_lanes``) and the
escape correction maps (``correction_maps``).

Persistence (``state_dict``, ``save``, ``load_state_dict``, ``load``) is
one pickle with the JAX file's top-level keys (``module_class``,
``config``, ``params``, ``tables``, ``scale_table``) plus ``"layout":
"torch"``: ``params`` maps the model's dotted state_dict names to numpy
arrays.  ``load_state_dict`` also takes a file the JAX package wrote (a
nested flax tree, no ``layout``) through ``hesic_from_jax``, and reads
through ``utils.persist.read_pickle``, which admits numpy and nothing
else (loading a JAX file imports no JAX).
"""

from __future__ import annotations

import contextlib
import copy
from typing import Dict, Optional

import numpy as np
import torch

from ..entropy_models import (CdfTables, compress_with_indexes,
                              decode_streams_batch, decompress_with_indexes,
                              gaussian_tables, get_scale_table,
                              tables_from_pmf)
from ..utils.persist import load_params, params_of, read_pickle, \
    write_pickle
from ..utils.tracing import call, count, span


def deterministic_backends():
    """The codec's determinism policy: deterministic cuDNN algorithms
    chosen without benchmarking, and no TF32 in convolutions or matmuls."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


def counted_flops(fn, *args, **kwargs) -> tuple:
    """(fn(*args, **kwargs), the FLOPs torch.utils.flop_counter.
    FlopCounterMode counted in it): PyTorch's count of matmuls and
    convolutions (and their backward), 2 a multiply-add, whatever the
    dtype.  Elementwise work, gathers and the CUDA kernels are not
    counted; kernel 5 runs as an operator the counter does not look into
    on either device (models/wavefront.py)."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        out = fn(*args, **kwargs)
    return out, float(counter.get_total_flops())


# ---- the device codecs' container pieces ----

def escape_record(idx: np.ndarray, vals: np.ndarray) -> bytes:
    """An eye's escapes (latents coded outside the grid) as the containers
    hold them: u32 n | u32 flat NHWC index[n] | i32 value[n]."""
    return (np.array([idx.size], np.uint32).tobytes()
            + idx.astype(np.uint32).tobytes()
            + vals.astype(np.int32).tobytes())


def read_escape_record(blob: bytes, off: int):
    """Inverse of escape_record at byte `off` of `blob` -> (u32 indices,
    i32 values, both views of `blob`; the next offset)."""
    n = int(np.frombuffer(blob, np.uint32, 1, off)[0])
    idx = np.frombuffer(blob, np.uint32, n, off + 4)
    vals = np.frombuffer(blob, np.int32, n, off + 4 + 4 * n)
    return idx, vals, off + 4 + 8 * n


def length_prefixed(strings) -> bytes:
    """Byte strings, each behind its u32 length."""
    return b"".join(np.array([len(s)], np.uint32).tobytes() + s
                    for s in strings)


def prefixed_extents(blob: bytes, off: int, n: int):
    """The (start, end) byte extents of the `n` length-prefixed strings at
    byte `off` of `blob`, and the offset after them."""
    extents = []
    for _ in range(n):
        length = int(np.frombuffer(blob, np.uint32, 1, off)[0])
        extents.append((off + 4, off + 4 + length))
        off += 4 + length
    return extents, off


def pack_parts(parts) -> tuple:
    """Host arrays -> (one int32 array holding them all, each part's int32
    count in it), for a single upload: u16 parts two to an int (padded to
    an even count), u32 and f32 parts as their bit patterns, every other
    part cast to int32.  split_parts takes it apart on the device."""
    flat = []
    for p in parts:
        if p.dtype == np.uint16:
            even = np.zeros(-(-p.size // 2) * 2, np.uint16)
            even[:p.size] = p.reshape(-1)
            p = even
        if p.dtype in (np.uint16, np.uint32, np.float32):
            p = p.view(np.int32)
        flat.append(p.astype(np.int32, copy=False).reshape(-1))
    return np.concatenate(flat), [p.size for p in flat]


def split_parts(buf: torch.Tensor, parts, sizes) -> list:
    """pack_parts's array uploaded -> each part flat on the device, with
    its values: u16 parts as int32, u32 parts as int64, f32 parts as
    float32, the others as int32."""
    out = []
    for p, t in zip(parts, torch.split(buf, sizes)):
        if p.dtype == np.uint16:
            t = t.view(torch.int16)[:p.size].to(torch.int32) & 0xFFFF
        elif p.dtype == np.uint32:
            t = t.to(torch.int64) & 0xFFFFFFFF
        elif p.dtype == np.float32:
            t = t.view(torch.float32)
        out.append(t)
    return out


def u16(w: torch.Tensor) -> torch.Tensor:
    """int32 u16 values -> int16 tensors of their bit patterns."""
    return (w - ((w >> 15) << 16)).to(torch.int16)


def expand_lanes(flat: torch.Tensor, counts: torch.Tensor,
                 cap: int) -> torch.Tensor:
    """Lane-major u16 words (int32 values: each lane's first `count`
    words, lane after lane) and (L,) counts -> the (L, cap) int32 buffer
    a decoder kernel reads, zero past each lane's count.  A gather, where
    the words are."""
    c = counts.to(torch.int64)
    start = torch.cumsum(c, 0) - c
    j = torch.arange(cap, device=flat.device)
    keep = j[None, :] < c[:, None]
    src = torch.where(keep, start[:, None] + j[None, :], 0)
    padded = torch.cat([flat, flat.new_zeros(1)])
    return torch.where(keep, padded[src], 0)


def correction_maps(at: torch.Tensor, vals: torch.Tensor, size: int):
    """Escape corrections on the device: int64 flat indices and int32
    values -> (mask, value) int32 vectors of `size`, by scatter (nothing
    is read back or stored by index from the host)."""
    mask = torch.zeros(size, dtype=torch.int32, device=at.device)
    val = torch.zeros_like(mask).scatter_(0, at, vals)
    return mask.scatter_(0, at, 1), val


def _load_weights(model, state: dict) -> None:
    cls = state.get("module_class")
    if cls is not None and cls != type(model).__name__:
        raise ValueError(f"checkpoint of a {cls}, not a "
                         f"{type(model).__name__}")
    load_params(model, state)


def _nhwc_outputs(out):
    """A forward's dict with every 4-D tensor (B, C, H, W) as (B, H, W,
    C), nested dicts included."""
    if isinstance(out, dict):
        return {k: _nhwc_outputs(v) for k, v in out.items()}
    if torch.is_tensor(out) and out.dim() == 4:
        return out.permute(0, 2, 3, 1)
    return out


class CompressionModel:
    """Pairs a model (HESIC, DSIC, HESIC+, mbt2018) with its host coder
    state."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.device = next(model.parameters()).device
        self.tables: Dict[str, CdfTables] = {}
        self.scale_table: Optional[np.ndarray] = None
        self._medians: Dict[str, np.ndarray] = {}

    def _median(self, name: str) -> torch.Tensor:
        """The named bottleneck's medians as a (1, C, 1, 1) tensor on the
        model's device."""
        return getattr(self.model, name).medians()[None, :, None, None]

    def _upload(self, a) -> torch.Tensor:
        """A host array as a tensor on the codec device.  On the card it
        goes up from pinned memory without blocking the host.  A dense
        array keeps its memory order (a channel-permuted image is not
        transposed on the host: one linear copy, then the device reorders
        it).  The pinned buffer may be dropped at once: PyTorch's caching
        host allocator records an event for the non-blocking copy out of
        it and does not hand the block out again before that event has
        passed.  Traced as ``count/h2d_bytes`` (on the CPU, the bytes the
        card would take)."""
        a = np.asarray(a)
        count("h2d_bytes", a.nbytes)
        if not a.flags.writeable:
            a = a.copy(order="K")
        host = torch.from_numpy(a)
        if self.device.type != "cuda":
            return host
        pinned = torch.empty_like(host, pin_memory=True)
        pinned.copy_(host)
        return pinned.to(self.device, non_blocking=True)

    def _to_device(self, x) -> torch.Tensor:
        """(B, H, W, 3) images -> (B, 3, H, W) float32 on the codec device;
        a tensor already there is not copied."""
        if not (torch.is_tensor(x) and x.device == self.device):
            x = self._upload(x.numpy() if torch.is_tensor(x)
                             else np.asarray(x, np.float32))
        return x.to(torch.float32).permute(0, 3, 1, 2).contiguous()

    def _homographies(self, h_matrix, b: int):
        """(B, 3, 3) or (1, 3, 3) homographies -> ((B, 3, 3) float32 on the
        codec device, the same as a numpy array taken from the argument).
        A homography passed as a CUDA tensor is read back to the host.  A
        subclass whose model takes no homography reads None as it needs."""
        if h_matrix is None:
            raise ValueError(f"{type(self).__name__} needs the pairs' "
                             f"homographies")
        h_np = (h_matrix.detach().cpu().numpy() if torch.is_tensor(h_matrix)
                else np.asarray(h_matrix))
        h_np = h_np.astype(np.float32).reshape(-1, 3, 3)
        if h_np.shape[0] != b:
            h_np = np.broadcast_to(h_np, (b, 3, 3))
        h_np = np.ascontiguousarray(h_np)
        return self._upload(h_np), h_np

    def update(self, scale_table=None, force: bool = False):
        """(Re)build the integer CDF tables of every entropy bottleneck,
        and for a model with Gaussian conditionals the scale table
        (`scale_table`, or ``get_scale_table()``) and one set of Gaussian
        tables that every conditional shares.  The PMF tables are
        evaluated on the CPU in float32, so the tables do not depend on
        the card."""
        for name in self.model.entropy_bottlenecks:
            if name in self.tables and not force:
                continue
            eb = copy.deepcopy(getattr(self.model, name)).to("cpu")
            pmf, tail, length, offset = eb.pmf_data()
            self.tables[name] = tables_from_pmf(
                pmf.numpy(), tail.numpy(), length.numpy(), offset.numpy())
            self._medians[name] = eb.medians().detach().numpy().copy()
        gc_names = getattr(self.model, "gaussian_conditionals", ())
        if gc_names and (self.scale_table is None or scale_table is not None
                         or force):
            self.scale_table = (np.asarray(scale_table)
                                if scale_table is not None
                                else get_scale_table())
            gc = gaussian_tables(self.scale_table)
            for name in gc_names:
                self.tables[name] = gc
        return self

    def forward(self, *args, training: bool = False, generator=None):
        """The model's forward in the JAX codec API's layout: images (B,
        H, W, 3) and homographies (B, 3, 3) (numpy or tensors) in; every
        4-D output (x_hat, x1_hat, x2_hat, y_hat, the likelihood maps)
        out as NHWC, the likelihoods under the model's names.  With
        ``training=False`` the model runs in eval mode without a
        gradient; `generator` draws the training noise."""
        b = next(a.shape[0] for a in args if np.ndim(a) == 4)
        args = [self._to_device(a) if np.ndim(a) == 4
                else self._homographies(a, b)[0] for a in args]
        was_training = self.model.training
        self.model.train(training)
        try:
            with torch.set_grad_enabled(training and torch.is_grad_enabled()):
                out = self.model(*args, training=training,
                                 generator=generator)
        finally:
            self.model.train(was_training)
        return _nhwc_outputs(out)

    def aux_loss(self) -> torch.Tensor:
        """The entropy bottlenecks' quantile loss (the model's)."""
        return self.model.aux_loss()

    def eb_medians(self, name: str) -> np.ndarray:
        """(C,) float32 medians of the named bottleneck (set by update)."""
        return self._medians[name]

    # ---- persistence ----

    def config(self) -> dict:
        """The model's widths among N, M, K, F, C."""
        return {f: getattr(self.model, f) for f in ("N", "M", "K", "F", "C")
                if hasattr(self.model, f)}

    def state_dict(self) -> dict:
        return {"module_class": type(self.model).__name__,
                "config": self.config(), "layout": "torch",
                "params": params_of(self.model),
                "tables": {k: v.state_dict() for k, v in self.tables.items()},
                "scale_table": self.scale_table}

    def save(self, path: str) -> None:
        write_pickle(path, self.state_dict())

    def load_state_dict(self, state: dict):
        """Load weights (on the model's device, in place), tables and the
        scale table from a ``state_dict`` of the port or the JAX
        package."""
        _load_weights(self.model, state)
        self._set_tables(state.get("tables"), state.get("scale_table"))
        return self

    def _set_tables(self, tables, scale_table) -> None:
        self.tables = {k: CdfTables.from_state_dict(v)
                       for k, v in (tables or {}).items()}
        self.scale_table = (None if scale_table is None
                            else np.asarray(scale_table))
        self._medians = {
            name: getattr(self.model, name).medians().detach().cpu()
            .numpy().copy() for name in self.model.entropy_bottlenecks}
        self._weights_loaded()

    def _weights_loaded(self) -> None:
        """Rebuild what a codec derives from the weights (nothing here)."""

    @classmethod
    def load(cls, model: torch.nn.Module, path: str) -> "CompressionModel":
        return cls(model).load_state_dict(read_pickle(path))

    def eb_encode_symbols(self, name: str, symbols: np.ndarray) -> list:
        """(B, zh, zw, C) int symbols -> one z string per item."""
        indexes = np.broadcast_to(
            np.arange(symbols.shape[-1], dtype=np.int32), symbols.shape)
        return compress_with_indexes(symbols, indexes, self.tables[name])

    def eb_decode_streams(self, name: str, blob: bytes, extents,
                          spatial_shape) -> np.ndarray:
        """Decode len(extents) z streams at byte extents [(lo, hi), ...]
        of `blob` in one native call -> (n, zh, zw, C) int32."""
        c = self.eb_medians(name).shape[0]
        zh, zw = int(spatial_shape[0]), int(spatial_shape[1])
        idx = np.broadcast_to(np.arange(c, dtype=np.int32), (zh, zw, c))
        begins = np.array([e[0] for e in extents], np.int64)
        ends = np.array([e[1] for e in extents], np.int64)
        out = decode_streams_batch(blob, begins, ends, idx,
                                   self.tables[name])
        return out.reshape(len(extents), zh, zw, c)

    # ---- channel-major host coding (the JAX package's host codecs) ----

    def eb_compress(self, name: str, z: torch.Tensor) -> list:
        """(B, C, zh, zw) z -> one string per item, symbols round(z -
        medians) in channel-major (NCHW flatten) order."""
        medians = self.eb_medians(name)[:, None, None]
        symbols = np.round(z.detach().float().cpu().numpy()
                           - medians).astype(np.int32)
        indexes = np.broadcast_to(
            np.arange(symbols.shape[1], dtype=np.int32)[:, None, None],
            symbols.shape)
        return compress_with_indexes(symbols, indexes, self.tables[name])

    def eb_decompress(self, name: str, strings: list,
                      spatial_shape) -> torch.Tensor:
        """Inverse of eb_compress -> (B, C, zh, zw) float32 z_hat on the
        codec device, contiguous."""
        medians = self.eb_medians(name)
        c = medians.shape[0]
        shape = (len(strings), c, int(spatial_shape[0]),
                 int(spatial_shape[1]))
        indexes = np.broadcast_to(
            np.arange(c, dtype=np.int32)[:, None, None], shape)
        symbols = decompress_with_indexes(strings, indexes,
                                          self.tables[name])
        return self._upload(symbols.astype(np.float32)
                            + medians[:, None, None])

    def gc_compress(self, name: str, y: torch.Tensor, indexes: torch.Tensor,
                    means: Optional[torch.Tensor] = None) -> list:
        """Code (B, C, h, w) y through the Gaussian tables given its
        scale-table indexes (build_indexes), about `means` when given:
        one string per item, channel-major."""
        y = y.detach().float().cpu().numpy()
        if means is not None:
            y = y - means.detach().float().cpu().numpy()
        symbols = np.round(y).astype(np.int32)
        return compress_with_indexes(
            symbols, indexes.cpu().numpy().astype(np.int32),
            self.tables[name])

    def gc_decompress(self, name: str, strings: list, indexes: torch.Tensor,
                      means: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Inverse of gc_compress -> (B, C, h, w) float32 y_hat on the
        codec device."""
        symbols = decompress_with_indexes(
            strings, indexes.cpu().numpy().astype(np.int32),
            self.tables[name])
        out = symbols.astype(np.float32)
        if means is not None:
            out = out + means.detach().float().cpu().numpy()
        return self._upload(out)


class PipelinedCodec(CompressionModel):
    """The fast codecs' pipelined serving protocol (HESIC's and DSIC's
    ``HESICFastCodec``, HESIC+'s ``HESICPlusDeviceCodec``).

    ``compress_fast`` codes a batch synchronously; ``compress_fast_start``
    only dispatches its device half, and ``compress_fast_finish`` waits
    for that batch's copies alone and writes its batch container;
    ``decompress_fast_batch`` only dispatches a decode.  Each is a span
    ``codec/<method>`` holding the encode's or decode's sequence number
    (``count/batch``).  A codec supplies the hooks: ``_encode_device(x1,
    x2, h_matrix)`` the dispatched device half (a handle: its "mode"
    "async", "seq", and ``_fetch``'s keys), ``_finish(handle,
    batch_container)`` the host half, ``_decompress_fast_batch(blob,
    pairs)`` the decode, and ``_start`` where its first start differs.

    The streams (the card only): all compute runs on the current stream.
    ``_fetch`` copies what the host half reads into pinned buffers on the
    start stream, after an event on the compute stream; the finish's work
    (the counted words, any gather it needs) runs on the finish stream
    after that event, so it never queues behind a later start's copies.
    Nothing on the two dispatch paths reads a device value back."""

    def __init__(self, model):
        super().__init__(model)
        self._side_streams = None
        # encodes and decodes begun: the next one's sequence number, which
        # its trace's count/batch carries
        self._encodes = 0
        self._decodes = 0

    def _streams(self):
        """(start stream, finish stream) of the codec's card, made once."""
        if self._side_streams is None:
            self._side_streams = (torch.cuda.Stream(self.device),
                                  torch.cuda.Stream(self.device))
        return self._side_streams

    def _fetch(self, dev: dict) -> dict:
        """Start the device -> host copies of `dev` ({name: tensor}).  On
        the card: an event on the compute stream, then the copies into
        pinned buffers on the start stream.  Returns {"ready": the compute
        event, "copied": the copies' event, "host": {name: host tensor}};
        on the CPU the tensors themselves, and no events."""
        count("d2h_bytes", sum(t.nbytes for t in dev.values()))
        if self.device.type != "cuda":
            return {"ready": None, "copied": None, "host": dict(dev)}
        ready = torch.cuda.Event()
        ready.record()
        stream = self._streams()[0]
        stream.wait_event(ready)
        host = {}
        with torch.cuda.stream(stream):
            for name, t in dev.items():
                t.record_stream(stream)
                host[name] = torch.empty(t.shape, dtype=t.dtype,
                                         pin_memory=True)
                host[name].copy_(t, non_blocking=True)
            copied = torch.cuda.Event()
            copied.record(stream)
        return {"ready": ready, "copied": copied, "host": host}

    @staticmethod
    def _fetched(handle) -> dict:
        """Wait for the handle's copies: {name: numpy array}."""
        if handle["copied"] is not None:
            handle["copied"].synchronize()
        return {k: t.numpy() for k, t in handle["host"].items()}

    def _on_finish_stream(self, handle, tensors):
        """A context that runs on the finish stream after the handle's
        compute event, `tensors` kept for it (the CPU: no context)."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        stream = self._streams()[1]
        stream.wait_event(handle["ready"])
        for t in tensors:
            t.record_stream(stream)
        return torch.cuda.stream(stream)

    def _fetch_words(self, handle, totals, tensors, flatten) -> list:
        """Each eye's counted words (`totals` of them) as numpy u16, copied
        on the finish stream after the handle's compute event: `flatten()`
        gives the eyes' flat int16 words there, from `tensors`."""
        count("d2h_bytes", 2 * sum(totals))
        with span("enc/words-d2h"):
            with self._on_finish_stream(handle, tensors):
                flats = flatten()
                if self.device.type == "cuda":
                    host = [torch.empty(n, dtype=torch.int16,
                                        pin_memory=True) for n in totals]
                    for dst, f in zip(host, flats):
                        dst.copy_(f, non_blocking=True)
                    done = torch.cuda.Event()
                    done.record()
                else:
                    host, done = flats, None
        with span("enc/wait-words"):
            if done is not None:
                done.synchronize()
        return [t.numpy().view(np.uint16) for t in host]

    def _start(self, x1, x2, h_matrix) -> dict:
        """compress_fast_start's handle: the device half, dispatched."""
        return self._encode_device(x1, x2, h_matrix)

    @torch.no_grad()
    def compress_fast(self, x1, x2, h_matrix=None,
                      batch_container: bool = False) -> dict:
        """Compress a batch of pairs.  x1/x2: (B, H, W, 3); h: (B, 3, 3) or
        (1, 3, 3), or None for a model that takes none.  Returns {'blobs':
        the containers, 'blob': the first, 'bpp_real', 'enctime', and the
        codec's escape counts}; a codec with per-pair containers writes
        the batch's one with batch_container=True."""
        with call("codec/compress_fast", self._encodes, self.device):
            return self._finish(self._encode_device(x1, x2, h_matrix),
                                batch_container)

    @torch.no_grad()
    def compress_fast_start(self, x1, x2, h_matrix=None) -> dict:
        """Dispatch-only half of a pipelined batch encode: nothing waits
        for the device.  Returns the handle for compress_fast_finish."""
        with call("codec/compress_fast_start", self._encodes, self.device):
            return self._start(x1, x2, h_matrix)

    @torch.no_grad()
    def compress_fast_finish(self, handle) -> dict:
        """The batch container of a compress_fast_start handle
        (compress_fast's keys): waits for that batch's copies only.
        ``fallback`` is always False: the port's pipelined encode has
        nothing to fall back from."""
        with call("codec/compress_fast_finish", handle["seq"], self.device):
            if handle["mode"] == "sync":
                return handle["out"]
            out = self._finish(handle, True)
            out["fallback"] = False
            return out

    @torch.no_grad()
    def decompress_fast_batch(self, blob: bytes, pairs: slice = None) -> dict:
        """Decode a batch container, or only its `pairs` (a contiguous
        slice of the batch, where the codec's layout allows one).  Only
        dispatches: ``dectime`` is the dispatch time, and the caller
        synchronises when it needs the results."""
        with call("codec/decompress_fast_batch", self._decodes, self.device):
            self._decodes += 1
            return self._decompress_fast_batch(blob, pairs)


class TogetherCodec(CompressionModel):
    """Codec of a stage-2 model (models/hesic.py ``Together``: HESIC,
    HESIC+ or DSIC with its enhancement): an inner codec of
    ``inner_codec_cls`` over ``model.m1`` does all the coding, and the
    enhancement ``model.enhance`` runs on both reconstructions after
    decoding, as the reference's wrappers run it outside the codec flow.
    The tables are the inner codec's, named under ``m1/``.  A decode
    result keeps the inner codec's reconstructions as ``x1_hat_base`` and
    ``x2_hat_base``; ``x1_hat``/``x2_hat`` are the enhanced ones (NHWC, of
    the enhancement's dtype)."""

    inner_codec_cls: type = None
    enhance_with_h = True   # m2 takes (x1, x2, h), else (x1, x2)

    def __init__(self, model):
        super().__init__(model)
        self.inner = self.inner_codec_cls(model.m1)

    def update(self, scale_table=None, force: bool = False):
        self.inner.update(scale_table=scale_table, force=force)
        self.tables = {f"m1/{k}": v for k, v in self.inner.tables.items()}
        self.scale_table = self.inner.scale_table
        return self

    def load_state_dict(self, state: dict):
        """Load the whole model (m1 and m2), then a new inner codec over
        m1 with the tables named under ``m1/``."""
        _load_weights(self.model, state)
        self.inner = self.inner_codec_cls(self.model.m1)
        self.inner._set_tables(
            {k[len("m1/"):]: v
             for k, v in (state.get("tables") or {}).items()},
            state.get("scale_table"))
        self.tables = {f"m1/{k}": v for k, v in self.inner.tables.items()}
        self.scale_table = self.inner.scale_table
        return self

    def compress(self, *args, **kwargs) -> dict:
        return self.inner.compress(*args, **kwargs)

    @torch.no_grad()
    def _enhance(self, out: dict) -> dict:
        """Apply the enhancement to a decode result, keeping the inner
        codec's reconstructions under *_base."""
        def nchw(t):
            return t.permute(0, 3, 1, 2).contiguous()

        x1, x2 = nchw(out["x1_hat"]), nchw(out["x2_hat"])
        args = (x1, x2)
        if self.enhance_with_h:
            args += (self._homographies(out["h_matrix"], x1.shape[0])[0],)
        enh = self.model.enhance(*args)
        return dict(out, x1_hat=enh["x1_hat"].permute(0, 2, 3, 1),
                    x2_hat=enh["x2_hat"].permute(0, 2, 3, 1),
                    x1_hat_base=out["x1_hat"], x2_hat_base=out["x2_hat"])

    def decompress(self, *args, **kwargs) -> dict:
        return self._enhance(self.inner.decompress(*args, **kwargs))

    def decompress_bytes(self, *args, **kwargs) -> dict:
        return self._enhance(self.inner.decompress_bytes(*args, **kwargs))
