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
from ..utils.tracing import count


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
