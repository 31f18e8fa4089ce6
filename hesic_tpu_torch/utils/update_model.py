"""Rebuild a trained checkpoint's coder tables and save it again.

Counterpart of hesic_tpu/utils/update_model.py (the reference's
``python -m compressai.utils.update_model``): loads a checkpoint, runs
``update(force=True)`` to rebuild the integer CDF tables, and saves the
codec under a sha256-suffixed file name beside it (or in ``--dir``).

Usage: python -m hesic_tpu_torch.utils.update_model --arch hesic \
           checkpoint.pkl [--device cpu]
"""

from __future__ import annotations

import argparse
import hashlib
import os

from ..zoo import create_model


def sha256_file(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("checkpoint")
    parser.add_argument("--arch", required=True)
    parser.add_argument("--quality", type=int, default=1)
    parser.add_argument("--name", default=None,
                        help="output base name (default: input stem)")
    parser.add_argument("--dir", default=None)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)

    codec = create_model(args.arch, quality=args.quality,
                         checkpoint=args.checkpoint, device=args.device)
    codec.update(force=True)

    directory = args.dir or os.path.dirname(args.checkpoint) or "."
    stem = args.name or os.path.splitext(
        os.path.basename(args.checkpoint))[0]
    tmp_path = os.path.join(directory, f"{stem}.tmp.pkl")
    codec.save(tmp_path)
    digest = sha256_file(tmp_path)[:8]
    out_path = os.path.join(directory, f"{stem}-{digest}.pkl")
    os.replace(tmp_path, out_path)
    print(out_path)
    return out_path


if __name__ == "__main__":
    main()
