"""Port parity: the interaction rebuild (plain version of kernel K2) against
the JAX package's ``build_interaction``, field by field, on closest hits of
camera and bounce rays in the small matte dragon (mesh with vertex normals
and uv, ground and light quads without), misses included.

Tolerance: float fields within 1e-5 absolute or relative; ids equal."""
import jax.numpy as jnp
import numpy as np
import torch

from rustracer_tpu.core.ray import make_ray
from rustracer_tpu.scene.tables import _closest_prim
from rustracer_tpu.scene.tables import build_interaction as jax_build
from rustracer_tpu_torch import convert
from rustracer_tpu_torch.core.ray import Ray
from rustracer_tpu_torch.scene.tables import build_interaction

from test_torch_geometry import jax_dragon_matte

torch.set_num_threads(1)

FLOAT_FIELDS = ("t", "p", "p_error", "wo", "n", "uv", "dpdu", "dpdv", "ns",
                "ss", "ts", "dndu", "dndv")
INT_FIELDS = ("valid", "material", "arealight", "prim_id")


def test_build_interaction_fields():
    jctx = jax_dragon_matte()[0]
    rs = np.random.default_rng(7)
    n = 4096
    cam = np.array([0.0, 1.1, -3.4], np.float32)
    o = np.where(np.arange(n)[:, None] < n // 2, cam,
                 rs.uniform(-2, 2, (n, 3)) * [1, 0.5, 1] + [0, 1.2, 0])
    target = rs.uniform(-1.5, 1.5, (n, 3)) * [1, 1, 1] + [0, -0.3, 0]
    d = target - o
    # the last 256 rays go up into the light quad
    o[-256:] = rs.uniform(-0.8, 0.8, (256, 3)) * [1, 0, 1] + [0, 2.0, 0]
    d[-256:] = rs.normal(0, 0.1, (256, 3)) + [0, 1, 0]
    d = (d / np.linalg.norm(d, axis=1, keepdims=True)).astype(np.float32)
    o = o.astype(np.float32)
    jray = make_ray(jnp.asarray(o), jnp.asarray(d))
    hit, t, prim, _ = _closest_prim(jctx.geom, jray)
    ref = jax_build(jctx.geom, jray, hit, t, prim)
    geom = convert.geometry_from_jax(jctx.geom, device="cpu")
    ray = Ray(o=torch.tensor(o), d=torch.tensor(d),
              t_max=torch.full((n,), float("inf")))
    out = build_interaction(geom, ray, torch.tensor(np.asarray(hit)),
                            torch.tensor(np.asarray(t)),
                            torch.tensor(np.asarray(prim)))
    h = np.asarray(hit)
    assert 0.3 < h.mean() < 0.95
    assert len(np.unique(np.asarray(ref.material)[h])) == 3
    for f in INT_FIELDS:
        np.testing.assert_array_equal(getattr(out, f).numpy(),
                                      np.asarray(getattr(ref, f)), err_msg=f)
    for f in FLOAT_FIELDS:
        np.testing.assert_allclose(getattr(out, f).numpy(),
                                   np.asarray(getattr(ref, f)),
                                   rtol=1e-5, atol=1e-5, err_msg=f)
