"""QA-vs-segmentation rank scatter of the paper's per-model scores
(scripts/demo/visualize_ranks.py; reference scripts/demo/
visualize_ranks.py:3-32): the paper's table (arXiv 2406.05821) is kept as
data; ranks are computed per column and the QA rank vs segmentation rank
of each model is printed, and plotted to ``ranks.png`` when matplotlib can
be imported.

Example:
  python -m flmm_tpu_torch.demo.visualize_ranks
"""

from __future__ import annotations

# rows: [MME, QA2, QA3, QA4, seg1..seg6] per model (reference :3-12)
SCORES = {
    "DeepSeekVL-1.3B": [1532, 64.6, 34.8, 51.1, 75.0, 62.8, 68.2, 64.9, 63.4, 68.3],
    "MGM-2B": [1653, 59.8, 31.1, 65.9, 75.0, 63.7, 67.3, 65.6, 64.4, 68.4],
    "LLaVA-1.5-7B": [1859, 64.3, 30.5, 69.0, 75.2, 63.7, 67.1, 64.8, 63.4, 68.2],
    "HPT-Air-7B": [1268, 69.8, 31.3, 59.2, 74.3, 64.0, 67.5, 65.5, 64.0, 68.8],
    "HPT-Air-1.5-8B": [1784, 75.2, 36.3, 62.1, 76.3, 64.5, 68.5, 65.4, 64.1, 68.5],
    "MGM-7B": [1839, 69.3, 40.8, 75.8, 75.7, 64.8, 68.3, 66.3, 65.3, 68.6],
    "DeepSeekVL-7B": [1766, 73.2, 41.5, 77.8, 76.1, 66.4, 70.1, 65.7, 64.5, 68.5],
    "LLaVA-Next-7B": [1841, 68.1, 44.1, 72.3, 75.8, 65.8, 70.1, 66.3, 65.1, 69.0],
    "LLaVA-Next-Mistral-7B": [1825, 69.5, 47.8, 71.7, 75.7, 66.5, 70.1, 66.5, 65.4, 69.1],
    "MGM-HD-7B": [1865, 65.8, 41.3, 74.0, 76.1, 65.2, 68.5, 66.7, 65.6, 69.1],
}


def ranks(values):
    order = sorted(range(len(values)), key=lambda i: -values[i])
    out = [0] * len(values)
    for r, i in enumerate(order):
        out[i] = r + 1
    return out


def main():
    names = list(SCORES)
    cols = list(zip(*SCORES.values()))
    qa_ranks = [ranks(list(c)) for c in cols[:4]]
    seg_ranks = [ranks(list(c)) for c in cols[4:]]

    def mean(rows, i):
        return sum(r[i] for r in rows) / len(rows)

    print(f"{'model':24s} {'QA rank':>8s} {'seg rank':>9s}")
    pts = []
    for i, n in enumerate(names):
        q, s = mean(qa_ranks, i), mean(seg_ranks, i)
        pts.append((q, s, n))
        print(f"{n:24s} {q:8.2f} {s:9.2f}")
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return
    fig, ax = plt.subplots(figsize=(6, 5))
    for q, s, n in pts:
        ax.scatter(q, s)
        ax.annotate(n, (q, s), fontsize=7)
    ax.set_xlabel("mean QA rank")
    ax.set_ylabel("mean segmentation rank")
    fig.savefig("ranks.png", dpi=150, bbox_inches="tight")
    print("saved ranks.png")


if __name__ == "__main__":
    main()
