"""Python-side utilities (counterpart of `soillib_tpu/util.py`; reference:
python/soillib/util.py): `iter_tiff`, `relief_shade`, `zip_save` /
`zip_load` and the plotting helpers.

The plotting helpers import matplotlib when they are called, never when
this module is imported. Where matplotlib is not installed they raise
ImportError; the examples skip their plots with `--out ""`. Fields may be
arrays or tensors on any device; the helpers that compute normals do so
on `device` (the card unless the caller passes device="cpu"; a tensor
stays on its own device).
"""

from __future__ import annotations

import os

import numpy as np

from soillib_tpu_torch.io.checkpoint import zip_load, zip_save  # re-export
from soillib_tpu_torch.io.tiff import _host
from soillib_tpu_torch.ops.stencil import normal as _normal

__all__ = [
    "zip_save", "zip_load", "iter_tiff", "relief_shade",
    "plot_area", "plot_dem", "plot_flow", "plot_images",
    "show_mass", "show_height", "show_normal", "show_relief",
    "show_discharge", "show_layers",
]


def iter_tiff(path, max_files=None):
    """Yield (file, path) for a single file or all files in a directory.
    Ref: util.py:8-30."""
    if not os.path.exists(path):
        raise RuntimeError("path does not exist")
    if os.path.isfile(path):
        yield os.path.basename(path), path
    elif os.path.isdir(path):
        for k, file in enumerate(sorted(os.listdir(path))):
            if max_files is not None and k > max_files:
                break
            yield file, os.path.join(path, file)
    else:
        raise RuntimeError("path must be file or directory")


def relief_shade(h, n):
    """Diffuse hillshade (numpy) from a height field and its (W, H, 3)
    normals, arrays or tensors on any device. Ref: util.py:32-53."""
    h = _host(h)
    n = _host(n)
    h_min = np.nanmin(h)
    h_max = np.nanmax(h)
    h = (h - h_min) / (h_max - h_min) if h_max > h_min else np.zeros_like(h)

    light = np.array([-1.0, 2.0, 1.0])
    light = light / np.linalg.norm(light)
    diffuse = np.sum(light * n, axis=-1)

    flattone = np.full(h.shape, 0.75)
    weight = 1.0
    return weight * diffuse + (1.0 - weight) * flattone


# ---------------------------------------------------------------------------
# Plotting helpers (ref: util.py:59-185)
# ---------------------------------------------------------------------------


def _plt():
    try:
        import matplotlib
    except ImportError as e:
        raise ImportError(
            "the soillib_tpu_torch.util plotting helpers need matplotlib, "
            "which is not installed; the examples skip their plots with "
            "--out \"\"") from e

    if not os.environ.get("DISPLAY"):
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _finish(plt, show, save):
    """Common tail of every plot helper: optional savefig + show."""
    if save:
        plt.savefig(save, dpi=120, bbox_inches="tight")
    if show and not save:
        plt.show()


def plot_area(area, show=True, save=None):
    plt = _plt()
    from matplotlib import colors

    area = _host(area)
    fig, ax = plt.subplots(figsize=(8, 6))
    fig.patch.set_alpha(0)
    plt.grid("on", zorder=0)
    im = ax.imshow(
        area, zorder=2, cmap="CMRmap",
        norm=colors.LogNorm(1, max(float(np.nanmax(area)), 1.0 + 1e-6)),
        interpolation="bilinear",
    )
    plt.colorbar(im, ax=ax, label="Upstream Cells")
    plt.tight_layout()
    _finish(plt, show, save)
    return fig


def plot_dem(dem, extent=None, show=True, save=None):
    """Terrain-colormapped elevation plot. Ref: util.py:75-88 (the pysheds
    (grid, dem) pair becomes an array + optional world extent)."""
    plt = _plt()
    dem = _host(dem)
    fig, ax = plt.subplots(figsize=(8, 6))
    fig.patch.set_alpha(0)
    im = ax.imshow(dem, extent=extent, cmap="terrain", zorder=1)
    plt.colorbar(im, ax=ax, label="Elevation (m)")
    plt.grid(zorder=0)
    plt.title("Digital elevation map", size=14)
    plt.xlabel("Longitude")
    plt.ylabel("Latitude")
    plt.tight_layout()
    _finish(plt, show, save)
    return fig


def plot_flow(fdir, show=True, save=None):
    """Flow-direction grid plot (receiver slots or fdir codes).
    Ref: util.py:90-105."""
    plt = _plt()
    fig = plt.figure(figsize=(8, 6))
    fig.patch.set_alpha(0)
    plt.imshow(_host(fdir), cmap="viridis", zorder=2)
    plt.colorbar()
    plt.xlabel("Longitude")
    plt.ylabel("Latitude")
    plt.title("Flow direction grid", size=14)
    plt.grid(zorder=-1)
    plt.tight_layout()
    _finish(plt, show, save)
    return fig


def show_mass(array, show=True, save=None):
    """Log-scaled suspended-mass plot (same rendering as show_discharge).
    Ref: util.py:144-151."""
    return show_discharge(array, show=show, save=save)


def show_height(tensor, show=True, save=None):
    plt = _plt()
    plt.imshow(_host(tensor))
    _finish(plt, show, save)


def show_normal(tensor, scale=(1.0, 1.0, 1.0), show=True, save=None,
                device=None):
    plt = _plt()
    n = _host(_normal(tensor, scale, device=device))
    plt.imshow(0.5 + 0.5 * n)
    _finish(plt, show, save)


def show_relief(tensor, scale=(1.0, 1.0, 1.0), show=True, save=None,
                device=None):
    plt = _plt()
    n = _host(_normal(tensor, scale, device=device))
    relief = relief_shade(tensor, n)
    plt.imshow(relief, cmap="gray")
    _finish(plt, show, save)


def show_discharge(array, show=True, save=None):
    plt = _plt()
    from matplotlib import colors

    array = 1 + _host(array)
    fig, ax = plt.subplots(figsize=(8, 6))
    ax.imshow(
        array, zorder=2, cmap="CMRmap",
        norm=colors.LogNorm(1, max(float(np.nanmax(array)), 1.0 + 1e-6)),
        interpolation="none",
    )
    _finish(plt, show, save)
    return fig


def show_layers(layers, scale=(1.0, 1.0, 1.0), show=True, save=None,
                device=None):
    """Sediment-colored relief. Ref: util.py:153-171."""
    plt = _plt()
    layers = _host(layers)
    if layers.shape[0] == 2:            # channel-first (2, W, H)
        height = layers[0] + layers[1]
        sediment = layers[1]
    else:                               # legacy channel-last (W, H, 2)
        height = layers[..., 0] + layers[..., 1]
        sediment = layers[..., 1]
    n = _host(_normal(height, scale, device=device))
    relief = 0.5 + 0.5 * relief_shade(height, n)
    shaded = np.repeat(relief[..., None], 3, axis=-1)
    shaded[sediment >= 0.0001] *= [0.0, 1.0, 1.0]
    shaded[sediment < 0.0001] *= [1.0, 0.0, 0.0]
    plt.imshow(shaded, interpolation="bilinear")
    _finish(plt, show, save)


def plot_images(images, show=True, save=None):
    plt = _plt()
    K = len(images)
    fig, ax = plt.subplots(1, K, figsize=(8, 4))
    fig.patch.set_alpha(0)
    for k, img in enumerate(images):
        ax[k].imshow(_host(img), zorder=2, cmap="CMRmap",
                     interpolation="bilinear")
    _finish(plt, show, save)
    return fig
