"""Checkpointing (counterpart of `soillib_tpu/io/checkpoint.py`).

* `zip_save` / `zip_load`: the reference's de-facto checkpoint format —
  each field written as a GeoTIFF, with its pixel scale, into a zip.
* `save_checkpoint` / `load_checkpoint`: step checkpoints of a state (an
  `ErosionState`, or nested dicts, lists and tuples of tensors) as
  `directory/step_{step}`, the JAX package's layout and signature. The
  file is `torch.save` of the state's tensors, not orbax's format; it is
  written to a temporary file and moved into place, so a reader never
  sees half a checkpoint.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import zipfile

import numpy as np
import torch

from soillib_tpu_torch.io.geotiff import geotiff
from soillib_tpu_torch.io.tiff import _host


def zip_save(output: str, fields: dict, pscale=(1.0, 1.0, 1.0)):
    """Write each (name -> 2-D array or tensor) field as a float32 GeoTIFF
    into the zip `output`."""
    with zipfile.ZipFile(output, "w") as z:
        for name, field in fields.items():
            tmp = f"{output}.{name}.tmp.tiff"
            g = geotiff(_host(field).astype(np.float32))
            g.meta.scale = [float(pscale[0]), float(pscale[1]),
                            float(pscale[2])]
            g.write(tmp)
            z.write(tmp, arcname=f"{name}.tiff")
            os.remove(tmp)


def zip_load(path: str) -> dict:
    """Inverse of zip_save: name -> (numpy array, meta)."""
    out = {}
    with zipfile.ZipFile(path) as z:
        for info in z.infolist():
            if not info.filename.endswith(".tiff"):
                continue
            tmp = f"{path}.{os.path.basename(info.filename)}.tmp"
            with open(tmp, "wb") as f:
                f.write(z.read(info.filename))
            g = geotiff(tmp)
            out[info.filename[: -len(".tiff")]] = (g.numpy(), g.meta)
            os.remove(tmp)
    return out


def _plain(tree):
    """The state as nested dicts, lists and tuples of tensors (a
    dataclass becomes the dict of its fields): what `torch.load` with
    weights_only=True reads back."""
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        return {f.name: _plain(getattr(tree, f.name))
                for f in dataclasses.fields(tree)}
    if isinstance(tree, dict):
        return {k: _plain(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_plain(v) for v in tree)
    return tree


def _restore(like, plain, path="state"):
    """`plain` rebuilt in the structure of `like`; every tensor must have
    the shape and dtype of `like`'s (orbax's restore against an abstract
    state)."""
    if dataclasses.is_dataclass(like) and not isinstance(like, type):
        names = [f.name for f in dataclasses.fields(like)]
        if not isinstance(plain, dict) or sorted(plain) != sorted(names):
            raise ValueError(f"{path}: the checkpoint does not hold the "
                             f"fields {names}")
        return dataclasses.replace(like, **{
            k: _restore(getattr(like, k), plain[k], f"{path}.{k}")
            for k in names})
    if isinstance(like, dict):
        if not isinstance(plain, dict) or sorted(plain) != sorted(like):
            raise ValueError(f"{path}: the checkpoint holds other keys")
        return {k: _restore(v, plain[k], f"{path}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(plain, (list, tuple)) or len(plain) != len(like):
            raise ValueError(f"{path}: the checkpoint holds another "
                             f"sequence")
        return type(like)(_restore(a, b, f"{path}[{i}]")
                          for i, (a, b) in enumerate(zip(like, plain)))
    if isinstance(like, torch.Tensor):
        if not isinstance(plain, torch.Tensor) or \
                plain.shape != like.shape or plain.dtype != like.dtype:
            raise ValueError(
                f"{path}: the checkpoint holds "
                f"{getattr(plain, 'shape', type(plain))} "
                f"{getattr(plain, 'dtype', '')}, expected "
                f"{tuple(like.shape)} {like.dtype}")
    return plain


def _first_device(tree):
    if isinstance(tree, torch.Tensor):
        return tree.device
    if dataclasses.is_dataclass(tree) and not isinstance(tree, type):
        tree = [getattr(tree, f.name) for f in dataclasses.fields(tree)]
    elif isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, (list, tuple)):
        for v in tree:
            dev = _first_device(v)
            if dev is not None:
                return dev
    return None


def save_checkpoint(directory: str, state, step: int) -> str:
    """Write `state` to `directory/step_{step}` (replacing an older one)
    and return that path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path),
                               prefix=f".step_{step}.")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(_plain(state), f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise
    return path


def load_checkpoint(directory: str, like, step: int, device=None):
    """The state saved at `directory/step_{step}`, in the structure of
    `like` (a state of the same fields and shapes), its tensors on
    `device`, by default the device of `like`'s tensors."""
    path = os.path.abspath(os.path.join(directory, f"step_{step}"))
    dev = device if device is not None else _first_device(like)
    plain = torch.load(path, map_location=dev, weights_only=True)
    return _restore(like, plain)
