"""A figure of image panels, drawn with matplotlib where it imports and
written as a PNG grid through data/png.py where it does not (the GPU
machine has no matplotlib).

The grid keeps the figure's layout without its titles: panels left to
right, top to bottom, each scaled as imshow scales it (RGB in [0, 1] as
is; a single channel from its own minimum to its maximum through the
named colour map, `jet` as matplotlib's piecewise-linear segments, `gray`
as a ramp).
"""
from __future__ import annotations

import os

import numpy as np

from splatam_tpu_torch.data.png import write_png

# matplotlib's _jet_data (matplotlib/_cm.py): (x, value) knots per channel.
_JET = (((0.0, 0.0), (0.35, 0.0), (0.66, 1.0), (0.89, 1.0), (1.0, 0.5)),
        ((0.0, 0.0), (0.125, 0.0), (0.375, 1.0), (0.64, 1.0), (0.91, 0.0), (1.0, 0.0)),
        ((0.0, 0.5), (0.11, 1.0), (0.34, 1.0), (0.65, 0.0), (1.0, 0.0)))


def jet(x: np.ndarray) -> np.ndarray:
    """[..., 3] RGB in [0, 1] of x in [0, 1] through matplotlib's jet."""
    return np.stack([np.interp(x, [k for k, _ in ch], [v for _, v in ch]) for ch in _JET], -1)


def to_rgb(img: np.ndarray, cmap: str | None) -> np.ndarray:
    """One panel as uint8 [H, W, 3], scaled as imshow scales it."""
    img = np.asarray(img, np.float64)
    if img.ndim == 3:
        rgb = np.clip(img, 0.0, 1.0)
    else:
        lo, hi = img.min(), img.max()
        x = (img - lo) / (hi - lo) if hi > lo else np.zeros_like(img)
        rgb = jet(x) if cmap == "jet" else np.repeat(x[..., None], 3, -1)
    return np.floor(rgb * 255.0 + 0.5).astype(np.uint8)


def panel_grid(panels: list, cols: int) -> np.ndarray:
    """uint8 [rows * H, cols * W, 3]: the (image, title, cmap) panels,
    equal in size, left to right and top to bottom."""
    tiles = [to_rgb(img, cmap) for img, _, cmap in panels]
    rows = [np.concatenate(tiles[i:i + cols], 1) for i in range(0, len(tiles), cols)]
    return np.concatenate(rows, 0)


class PanelFigure:
    """A 2 x 4 figure saved once per frame (reference: scripts/splatam.py:
    292-337). With matplotlib, under a DISPLAY the figure also stays open as
    a live window redrawn every frame (until a GUI backend fails once);
    without matplotlib the panels go out as a PNG grid."""

    ROWS, COLS = 2, 4

    def __init__(self):
        self.fig = None  # (figure, axes) of the live window
        self.live_failed = False

    def save(self, panels: list, path: str, title: str) -> None:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        try:
            import matplotlib
        except ImportError:
            write_png(path, panel_grid(panels, self.COLS))
            return
        live = bool(os.environ.get("DISPLAY")) and not self.live_failed
        if not live:
            matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        if live and self.fig is not None:
            fig, axs = self.fig
            for ax in axs.flatten():
                ax.clear()
        else:
            fig, axs = plt.subplots(self.ROWS, self.COLS, figsize=(16, 7))
            if live:
                try:
                    plt.ion()
                    fig.show()
                    self.fig = (fig, axs)
                except Exception:  # no usable GUI backend after all: files only from now on
                    self.live_failed, live = True, False
        for ax, (img, name, cmap) in zip(axs.flatten(), panels):
            ax.imshow(img, cmap=cmap)
            ax.set_title(name)
            ax.axis("off")
        fig.suptitle(title, fontsize=14)
        fig.tight_layout()
        fig.savefig(path, bbox_inches="tight")
        if live:
            fig.canvas.draw_idle()
            fig.canvas.flush_events()
        else:
            plt.close(fig)
