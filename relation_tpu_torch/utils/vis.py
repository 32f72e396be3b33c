"""Detection rendering (port of relation_tpu/utils/vis.py; reference
core/tester.py vis_all_detection / draw_all_detection). matplotlib is
imported at the call: only ``--vis`` of the test driver needs it."""

from __future__ import annotations

import numpy as np


def draw_detections(im_bgr: np.ndarray, dets: np.ndarray, class_names,
                    scale: float = 1.0, thresh: float = 1e-3,
                    out_path: str | None = None):
    """Render detections onto an image.

    im_bgr: [H, W, 3] float BGR (pipeline image before mean-sub, or add means
    back); dets: [N, 6] rows (cls, score, x1, y1, x2, y2) in original coords.
    Saves to out_path (if given) and returns the matplotlib figure.
    """
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    from matplotlib.patches import Rectangle

    rgb = np.clip(im_bgr[:, :, ::-1], 0, 255).astype(np.uint8)
    fig, ax = plt.subplots(1, figsize=(12, 9))
    ax.imshow(rgb)
    rng = np.random.RandomState(0)
    colors = rng.rand(max(len(class_names), 2), 3)
    for row in np.asarray(dets):
        cls = int(row[0])
        if cls < 1 or row[1] < thresh:
            continue
        x1, y1, x2, y2 = row[2:6] * scale
        color = colors[cls % len(colors)]
        ax.add_patch(Rectangle((x1, y1), x2 - x1, y2 - y1, fill=False,
                               edgecolor=color, linewidth=2))
        name = class_names[cls] if cls < len(class_names) else str(cls)
        ax.text(x1, y1 - 2, f"{name} {row[1]:.3f}", fontsize=9, color="white",
                bbox=dict(facecolor=color, alpha=0.6, pad=1))
    ax.axis("off")
    if out_path:
        fig.savefig(out_path, bbox_inches="tight", dpi=100)
        plt.close(fig)
    return fig
