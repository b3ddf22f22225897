"""Film checkpoint and resume (port of rustracer_tpu/render/checkpoint.py),
in the JAX package's file format, so that a checkpoint written by either
package loads in the other: an ``.npz`` of ``version`` 1, ``samples_done``,
``resolution`` (x, y), ``rgb`` (H, W, 3), ``wsum`` (H, W) and ``splat``
(H, W, 3), written atomically (a temporary file, then ``os.replace``).

The port's film state is one packed (H, W, 4) buffer (render/film.py), so
a load builds it with ``Film.init_state`` and copies the sums in. Its
``splat`` is None until ``add_splats``: it is written as zeros and zeros
read back as None.

The checkpointed render (render/renderer.py ``render_checkpointed``)
splats through K4d, whose per-pixel sums are taken in a fixed order, and
the samplers are deterministic per (pixel, sample): a resumed render is
bit for bit a checkpointed render run without a stop, for every filter.
Against a plain render, which loops (tile, sample) where the checkpointed
render loops (chunk, tile, sample) and splats through K4, it is bit for
bit where no filter footprint crosses a tile (the box filter, or one tile).
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from .film import Film, FilmState

FORMAT_VERSION = 1


def save_film_checkpoint(path: str, state: FilmState, samples_done: int,
                         resolution=None) -> None:
    """Atomic snapshot of the film state after ``samples_done`` samples
    per pixel."""
    rgb = state.rgb.detach().cpu().numpy()
    splat = np.zeros_like(rgb) if state.splat is None \
        else state.splat.detach().cpu().numpy()
    tmp = path + f".tmp{os.getpid()}"
    np.savez(
        tmp, version=np.int64(FORMAT_VERSION),
        samples_done=np.int64(samples_done),
        resolution=np.asarray(resolution if resolution is not None
                              else (rgb.shape[1], rgb.shape[0]), np.int64),
        rgb=rgb, wsum=state.wsum.detach().cpu().numpy(), splat=splat)
    # np.savez appends .npz to the temporary name
    os.replace(tmp + ".npz", path)


def load_film_checkpoint(path: str, film: Optional[Film] = None,
                         device="cpu") -> Tuple[FilmState, int]:
    """-> (FilmState on ``device``, samples_done): the packed buffer of
    ``film.init_state`` with the sums copied in (a film of the file's
    resolution and the box filter when ``film`` is None). Raises on another
    version or shape."""
    with np.load(path) as z:
        version = int(z["version"])
        if version != FORMAT_VERSION:
            raise ValueError(f"checkpoint {path}: version {version} != "
                             f"{FORMAT_VERSION}")
        rgb, wsum, splat = z["rgb"], z["wsum"], z["splat"]
        done = int(z["samples_done"])
    h, w = wsum.shape
    if film is None:
        film = Film(full_resolution=(w, h))
    state = film.init_state(device)
    if tuple(state.rgb.shape) != rgb.shape or \
            tuple(state.wsum.shape) != wsum.shape:
        raise ValueError(f"checkpoint {path}: film shape {rgb.shape} does "
                         f"not match the scene's {tuple(state.rgb.shape)}")
    state.rgb.copy_(torch.as_tensor(rgb))
    state.wsum.copy_(torch.as_tensor(wsum))
    if splat.any():
        state = state._replace(splat=torch.as_tensor(splat, device=device))
    return state, done


def maybe_resume(path: Optional[str], film: Film,
                 device="cpu") -> Tuple[Optional[FilmState], int]:
    """Load the checkpoint at ``path`` if it exists (it must match the
    film's shape) -> (state or None, samples_done)."""
    if not path or not os.path.exists(path):
        return None, 0
    return load_film_checkpoint(path, film, device)
