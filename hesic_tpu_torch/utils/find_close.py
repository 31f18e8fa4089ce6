"""Find the codec quality whose bpp/psnr/ms-ssim is closest to a target.

Counterpart of hesic_tpu/utils/find_close.py (the reference's
``python -m compressai.utils.find_close``): bisection over the codec's
quality range against a target metric value on one image.

Usage: python -m hesic_tpu_torch.utils.find_close jpeg image.png 0.5 \
           --metric bpp
"""

from __future__ import annotations

import argparse
import sys

from .bench_codecs import CODECS, BinaryCodec


def find_closest(codec, path: str, target: float, metric: str = "bpp"):
    """Interval bisection on the MEASURED metric value (reference
    find_close/__main__.py:52-87): the open interval (lo, hi) shrinks
    toward the quality whose metric brackets the target, with the
    direction flipped for QP/ratio-style knobs
    (``codec.quality_reversed``).  Bisecting on the value rather than
    on the quality index keeps the best-so-far answer correct when the
    metric plateaus across qualities (the measured value, not the
    index, decides which half can be discarded)."""
    lo, hi = codec.quality_range
    lo, hi = lo - 1, hi + 1          # open interval, endpoints excluded
    rev = codec.quality_reversed
    best = None
    while hi > lo + 1:
        mid = (lo + hi) // 2
        res = codec.run(path, mid)
        value = res[metric]
        if best is None or abs(value - target) < abs(best[1] - target):
            best = (mid, value, res)
        if value > target:
            # overshoot: drop the higher-metric half
            lo, hi = (mid, hi) if rev else (lo, mid)
        elif value < target:
            # undershoot: drop the lower-metric half
            lo, hi = (mid, hi) if not rev else (lo, mid)
        else:
            break
    return best


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("codec", choices=sorted(CODECS))
    parser.add_argument("image")
    parser.add_argument("target", type=float)
    parser.add_argument("--metric", default="bpp",
                        choices=["bpp", "psnr-rgb", "ms-ssim-rgb"])
    args = parser.parse_args(argv)
    codec = CODECS[args.codec]()
    if isinstance(codec, BinaryCodec) and not codec.available():
        print(f"binary for '{args.codec}' not found", file=sys.stderr)
        return 1
    quality, value, res = find_closest(codec, args.image, args.target,
                                       args.metric)
    print(f"quality={quality} {args.metric}={value:.4f} (target "
          f"{args.target})")
    for k, v in res.items():
        print(f"  {k}: {v:.4f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
