"""Multi-rank dry run (counterpart of the JAX package's
``__graft_entry__.py: dryrun_multichip``): N ranks in a ("data",
"sample") mesh (sample 2 where N is even) run one sharded render step and
one sharded train step of the 8^2 Cornell box with atlas imagemap walls
and the spatial light grid (K12 builds it, K13 picks from it).

    python -m rustracer_tpu_torch.parallel.dryrun N [--cpu] [--backend gloo]

On the card NCCL takes one rank a card; ``--backend gloo`` runs several
ranks on one card; ``--cpu`` runs them on the CPU over gloo. Raises
(exit code 1) unless the loss is finite, the leaves moved and the atlas
texels moved.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from .launch import spawn
from .mesh import (float_leaves, make_device_mesh, make_sharded_render_step,
                   make_sharded_train_step, sample_lanes)

RES = (8, 8)


def dryrun_rank(rank, world_size, device, n_sample):
    """One rank's dry run -> (mesh shape, loss)."""
    from ..scene.lightdistrib import build_spatial_grid
    from ..scenes import build_cornell
    mesh = make_device_mesh(sample=n_sample, device=device)
    ctx, cam, film, sampler, integ = build_cornell(
        res=RES, spp=n_sample, max_depth=2, imagemap_walls=(1, 2),
        device=device)
    ctx.light_grid = build_spatial_grid(ctx.lights, np.zeros(3, np.float32),
                                        np.ones(3, np.float32))
    px, py, valid = sample_lanes(film, mesh.shape[0])

    rstep = make_sharded_render_step(integ.li, cam, film, sampler, mesh)
    img = film.to_image(rstep(ctx, px, py, valid, 0))
    assert bool(torch.isfinite(img).all()), "the sharded render is not finite"

    train = make_sharded_train_step(integ.li, cam, film, sampler, mesh,
                                    lr=0.1)
    new_ctx, loss = train(ctx, img * 0.5, px, py, valid, 0)
    loss = float(loss)
    assert np.isfinite(loss), f"loss not finite: {loss}"
    old, _ = float_leaves(ctx.textures)
    new, _ = float_leaves(new_ctx.textures)
    assert any(not torch.allclose(a, b) for a, b in zip(old, new)), \
        "training step did not update parameters"
    assert any(not torch.allclose(a, b)
               for pa, pb in zip(ctx.textures["images"],
                                 new_ctx.textures["images"])
               for a, b in zip(pa, pb)), \
        "atlas imagemap texels did not update"
    return tuple(mesh.shape), loss


def dryrun(n: int, device="cuda", backend=None):
    """Spawn ``n`` ranks of the dry run -> (mesh shape, loss) of rank 0; a
    collective that waits 300 s for a peer fails its rank."""
    n_sample = 2 if n % 2 == 0 else 1
    out = spawn(dryrun_rank, n, n_sample, device=device, backend=backend,
                timeout=300.0)
    return out[0]


def main(argv=None):
    ap = argparse.ArgumentParser(prog="python -m "
                                 "rustracer_tpu_torch.parallel.dryrun")
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--cpu", action="store_true",
                    help="ranks on the CPU (gloo)")
    ap.add_argument("--backend", choices=("nccl", "gloo"),
                    help="nccl (the card's default) or gloo")
    a = ap.parse_args(argv)
    (data, sample), loss = dryrun(a.n, "cpu" if a.cpu else "cuda",
                                  a.backend)
    print(f"dryrun({a.n}): mesh={{'data': {data}, 'sample': {sample}}} "
          f"loss={loss:.6f} OK (atlas imagemap grads + spatial-grid NEE "
          f"exercised)", flush=True)


if __name__ == "__main__":
    main()
