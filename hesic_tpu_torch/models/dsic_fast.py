"""DSIC fast codec on the card: HESICFastCodec's containers and pipeline
with DSIC's programs.

Counterpart of hesic_tpu/models/dsic_fast.py (``DSICFastCodec``).  Every
container, the pipelined encode (``compress_fast_start`` /
``compress_fast_finish``) and both decoders are HESICFastCodec's, writer
byte included (17 card, 16 CPU twin); only the model's programs change:

* ``transforms_enc``: the left encoder's taps come from the true left
  image, the global contexts from the rounded left latent, as the
  reference codec flow does;
* ``cond2``: the right GMM head conditions on the un-warped decoded left
  latent, so there is no synthesis, warp or re-encode before it; its aux
  output is that latent as float32;
* ``_synthesize``: the left decoder's taps and the global contexts of the
  decoded left latent feed the cost-volume right decoder.

The cost-volume programs feed only the right latent's encoder and the
reconstructions, never the coder's conditioning.  DSIC takes no
homography: ``_homographies`` reads the default None of
``compress_fast`` and ``compress_fast_start`` as the identity, and the
header's ``win``/``xwin`` bytes are what the identity picks, as in the JAX
package.  ``compress`` / ``decompress`` / ``decompress_bytes`` are
DSICCodec's reference-layout container (the class is a DSICCodec first,
as the JAX one).  ``device_flops`` is HESICFastCodec's, over these
programs (``synth_out``'s aux input is the float left latent).
"""

from __future__ import annotations

import numpy as np
import torch

from .dsic_codec import DSICCodec
from .hesic_fast import HESICFastCodec, _data_center, _gmm_freq_fast


class DSICFastCodec(DSICCodec, HESICFastCodec):
    """DSIC with the fused on-device coder (see HESICFastCodec); its
    ``compress``/``decompress`` are DSICCodec's."""

    def _homographies(self, h_matrix, b: int):
        if h_matrix is None:
            h_matrix = np.eye(3, dtype=np.float32)[None]
        return super()._homographies(h_matrix, b)

    @torch.no_grad()
    def transforms_enc(self, x1, x2, h, win: int):
        """NCHW images -> (y1_hat, y2_hat, z1_sym, z2_sym, dc1, dc2, sp1,
        sp2); `h` and `win` are not used."""
        m = self.model
        y1, g1_1, g1_2, g1_3 = m.analysis1(x1)
        z1 = m.hyper_analysis1(y1)
        z1_sym = torch.round(z1 - self._median("entropy_bottleneck1"))
        y1_hat = torch.round(y1).to(torch.int32)
        contexts = m.contexts(y1_hat.float())
        y2 = m.analysis2(x2, g1_1, g1_2, g1_3, contexts)
        z2 = m.hyper_analysis2(y2)
        z2_sym = torch.round(z2 - self._median("entropy_bottleneck2"))
        y2_hat = torch.round(y2).to(torch.int32)
        dc1, sp1 = _data_center(y1_hat)
        dc2, sp2 = _data_center(y2_hat)
        return (y1_hat, y2_hat, z1_sym.to(torch.int32),
                z2_sym.to(torch.int32), dc1, dc2, sp1, sp2)

    def _cond2_fn(self, y1_hat, z2_sym, h, center, mm: int, win: int):
        """-> (frequency rows of eye 2, the float left latent)."""
        y1f = y1_hat.float()
        z2_hat = z2_sym.float() + self._median("entropy_bottleneck2")
        sigma, means, weights = self.model.gmm2(z2_hat, y1f)
        freq = _gmm_freq_fast(sigma, means, weights, mm, self.model.K,
                              center)
        return freq, y1f

    def _synthesize(self, aux, y2, h, win: int):
        x1_hat, g1_4, g1_5, g1_6 = self.model.synthesis1(aux)
        contexts = self.model.contexts(aux)
        return x1_hat, self.model.synthesis2(y2.float(), g1_4, g1_5, g1_6,
                                             contexts)
