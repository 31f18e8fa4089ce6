"""Host-side model wrapper: the HESIC module + the integer z coder tables.

Counterpart of the parts of hesic_tpu/models/base.py that the fast codec
uses: ``update()`` builds the EntropyBottleneck CDF tables, ``tables``
holds them, ``eb_medians`` gives the z symbol offsets, and the z-symbol
helpers code (B, zh, zw, C) symbol tensors in NHWC order (channel as the
table index), as hesic_tpu/models/hesic_fast.py's z path does.
"""

from __future__ import annotations

import copy
from typing import Dict

import numpy as np
import torch

from ..entropy_models import (CdfTables, compress_with_indexes,
                              decode_streams_batch, tables_from_pmf)


class CompressionModel:
    """Pairs a HESIC module with its host coder state."""

    def __init__(self, model: torch.nn.Module):
        self.model = model
        self.tables: Dict[str, CdfTables] = {}
        self._medians: Dict[str, np.ndarray] = {}

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
