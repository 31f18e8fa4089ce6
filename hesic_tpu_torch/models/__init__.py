"""The models and their codecs, with the JAX package's public names
(hesic_tpu/models/__init__.py): the CompressAI priors and Cheng2020 with
their host codecs; HESIC, HESIC+ and DSIC with their stage-2 (Together)
variants; the fast codecs of HESIC and DSIC (kernels 1-3), the wavefront
device codecs of mbt2018 and HESIC+ (kernels 4-5), the host AR codecs
and the reference-layout container codecs.

The submodules load eagerly.  ``base`` imports ``utils.persist``, whose
package exports the metrics only, so there is no cycle.
"""

from .ar_device import HESICPlusDeviceCodec, JointAutoregressiveDeviceCodec
from .base import CompressionModel, TogetherCodec
from .codec import (FactorizedPriorCodec, JointAutoregressiveCodec,
                    MeanScaleHyperpriorCodec, ScaleHyperpriorCodec)
from .dsic import (DSIC, CostVolume, DSICPlus, GlobalContext,
                   IndependentEnhancementNoWarp, dense_warp)
from .dsic_codec import DSICCodec, DSICPlusCodec
from .dsic_fast import DSICFastCodec
from .hesic import (HESIC, Enhancement, EnhancementBlock, HESICTogether,
                    IndependentEnhancement)
from .hesic_codec import HESICCodec, HESICTogetherCodec
from .hesic_fast import HESICFastCodec
from .hesic_plus import HESICPlus, HESICPlusTogether
from .hesic_plus_codec import HESICPlusCodec, HESICPlusTogetherCodec
from .hesic_plus_refcodec import HESICPlusRefCodec
from .priors import (FactorizedPrior, JointAutoregressiveHierarchicalPriors,
                     MeanScaleHyperprior, ScaleHyperprior)
from .waseda import Cheng2020Anchor, Cheng2020Attention

__all__ = [
    "CompressionModel",
    "TogetherCodec",
    "FactorizedPriorCodec",
    "JointAutoregressiveCodec",
    "MeanScaleHyperpriorCodec",
    "ScaleHyperpriorCodec",
    "FactorizedPrior",
    "JointAutoregressiveHierarchicalPriors",
    "MeanScaleHyperprior",
    "ScaleHyperprior",
    "Cheng2020Anchor",
    "Cheng2020Attention",
    "HESIC",
    "HESICCodec",
    "HESICFastCodec",
    "HESICTogether",
    "HESICTogetherCodec",
    "HESICPlus",
    "HESICPlusCodec",
    "HESICPlusRefCodec",
    "HESICPlusTogether",
    "HESICPlusTogetherCodec",
    "DSIC",
    "DSICCodec",
    "DSICFastCodec",
    "HESICPlusDeviceCodec",
    "JointAutoregressiveDeviceCodec",
    "DSICPlus",
    "DSICPlusCodec",
    "IndependentEnhancementNoWarp",
    "CostVolume",
    "GlobalContext",
    "dense_warp",
    "Enhancement",
    "EnhancementBlock",
    "IndependentEnhancement",
]
