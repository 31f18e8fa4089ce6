"""Host-side model wrapper: a stereo model + the integer z coder tables.

Counterpart of the parts of hesic_tpu/models/base.py that the codecs
use: ``update()`` builds the EntropyBottleneck CDF tables, ``tables``
holds them, ``eb_medians`` gives the z symbol offsets, and the z-symbol
helpers code (B, zh, zw, C) symbol tensors in NHWC order (channel as the
table index), as hesic_tpu/models/hesic_fast.py's z path does.  The
input helpers move the caller's NHWC images and homographies to the
model's device (on the card through pinned memory, without blocking the
host).  ``deterministic_backends`` is the codecs' shared
determinism policy.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from ..entropy_models import (CdfTables, compress_with_indexes,
                              decode_streams_batch, tables_from_pmf)


def deterministic_backends():
    """The codec's determinism policy: deterministic cuDNN algorithms
    chosen without benchmarking, and no TF32 in convolutions or matmuls."""
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


class CompressionModel:
    """Pairs a stereo model (HESIC, HESIC+) with its host coder state."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.device = next(model.parameters()).device
        self.tables: Dict[str, CdfTables] = {}
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
        passed."""
        a = np.asarray(a)
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

    def update(self, force: bool = False):
        """(Re)build the integer CDF tables of every entropy bottleneck.
        The PMF tables are evaluated on the CPU in float32, so the tables
        do not depend on the card."""
        for name in self.model.entropy_bottlenecks:
            if name in self.tables and not force:
                continue
            eb = copy.deepcopy(getattr(self.model, name)).to("cpu")
            pmf, tail, length, offset = eb.pmf_data()
            self.tables[name] = tables_from_pmf(
                pmf.numpy(), tail.numpy(), length.numpy(), offset.numpy())
            self._medians[name] = eb.medians().detach().numpy().copy()
        return self

    def eb_medians(self, name: str) -> np.ndarray:
        """(C,) float32 medians of the named bottleneck (set by update)."""
        return self._medians[name]

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
