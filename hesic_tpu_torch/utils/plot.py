"""Plot rate-distortion curves from result JSON files.

Counterpart of hesic_tpu/utils/plot.py (the reference's
``python -m compressai.utils.plot``): reads one or more result JSONs (as
eval_model and bench_codecs write them) and renders RD curves with
matplotlib, or with plotly as HTML (``--backend plotly``).  Both are
imported only when a plot is made.

Usage: python -m hesic_tpu_torch.utils.plot res1.json [res2.json ...] \
           --output rd.png
"""

from __future__ import annotations

import argparse
import json
import sys


def load_results(paths):
    out = []
    for p in paths:
        with open(p) as f:
            out.append(json.load(f))
    return out


def plot_rd(results, metric="psnr", title="RD curves", output=None,
            show=False):
    import matplotlib
    if not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 6))
    for res in results:
        r = res["results"]
        bpp = r["bpp"] if isinstance(r["bpp"], list) else [r["bpp"]]
        vals = r[metric] if isinstance(r[metric], list) else [r[metric]]
        order = sorted(range(len(bpp)), key=lambda i: bpp[i])
        ax.plot([bpp[i] for i in order], [vals[i] for i in order],
                marker="o", label=res.get("name", "?"))
    ax.set_xlabel("bpp")
    ax.set_ylabel(metric)
    ax.set_title(title)
    ax.grid(True, alpha=0.3)
    ax.legend()
    if output:
        fig.savefig(output, dpi=150, bbox_inches="tight")
    if show:
        plt.show()
    return fig


def plot_rd_plotly(results, metric="psnr", title="RD curves",
                   output=None):
    """Interactive backend (reference --backend=plotly,
    utils/plot/__main__.py); writes an HTML file."""
    try:
        import plotly.graph_objects as go
    except ImportError as e:  # pragma: no cover - plotly optional
        raise SystemExit(
            "plotly backend requested but plotly is not installed") from e
    fig = go.Figure()
    for res in results:
        r = res["results"]
        bpp = r["bpp"] if isinstance(r["bpp"], list) else [r["bpp"]]
        vals = r[metric] if isinstance(r[metric], list) else [r[metric]]
        order = sorted(range(len(bpp)), key=lambda i: bpp[i])
        fig.add_trace(go.Scatter(
            x=[bpp[i] for i in order], y=[vals[i] for i in order],
            mode="lines+markers", name=res.get("name", "?")))
    fig.update_layout(title=title, xaxis_title="bpp", yaxis_title=metric)
    fig.write_html(output or "rd_curves.html")
    return fig


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("results", nargs="+", help="result JSON files")
    parser.add_argument("--metric", default="psnr")
    parser.add_argument("--title", default="RD curves")
    parser.add_argument("--output", default=None)
    parser.add_argument("--show", action="store_true")
    parser.add_argument("--backend", choices=("matplotlib", "plotly"),
                        default="matplotlib")
    args = parser.parse_args(argv)
    results = load_results(args.results)
    if args.backend == "plotly":
        plot_rd_plotly(results, args.metric, args.title, args.output)
    else:
        plot_rd(results, args.metric, args.title, args.output, args.show)
    return 0


if __name__ == "__main__":
    sys.exit(main())
