"""Port parity of the row gather (ops/gather.py, the port of
tools/bench_gather_pallas.py): the plain version against the reference
tool's plain gather ``t[i]`` on seeded numpy inputs, bit-equal (a gather
moves values). The Pallas kernel itself needs a TPU (SMEM index blocks and
DMA semaphores); ``t[i]`` is its CPU reference. Also the wrapper's
refusals, which hold on every device."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rustracer_tpu_torch.ops.gather import row_gather, row_gather_plain

torch.set_num_threads(1)


@pytest.mark.parametrize("rows,width,batch", [(1 << 10, 128, 1 << 12),
                                              (3, 16, 257)])
def test_row_gather_bit_equal_to_reference(rows, width, batch):
    rs = np.random.RandomState(0)
    table = rs.rand(rows, width).astype(np.float32)
    idx = rs.randint(0, rows, batch).astype(np.int32)
    ref = np.asarray(jax.jit(lambda t, i: t[i])(jnp.asarray(table),
                                                jnp.asarray(idx)))
    for fn in (row_gather, row_gather_plain):
        out = fn(torch.as_tensor(table), torch.as_tensor(idx)).numpy()
        assert out.shape == (batch, width)
        np.testing.assert_array_equal(out.view(np.int32), ref.view(np.int32))


def _table(rows=8, width=128):
    return torch.rand((rows, width))


@pytest.mark.parametrize("case", [
    "float64 table", "int64 idx", "non-contiguous table", "width 6",
    "no rows", "2-D idx"])
def test_row_gather_refuses(case):
    table, idx = _table(), torch.zeros(4, dtype=torch.int32)
    if case == "float64 table":
        table = table.double()
    elif case == "int64 idx":
        idx = idx.long()
    elif case == "non-contiguous table":
        table = _table(8, 256)[:, ::2]
    elif case == "width 6":
        table = _table(8, 6)
    elif case == "no rows":
        table = _table(0)
    else:
        idx = idx[:, None]
    with pytest.raises(ValueError):
        row_gather(table, idx)


@pytest.mark.parametrize("rows,width,batch", [(3, 16, 4099), (1 << 10, 128,
                                                              1 << 12)])
def test_row_gather_vjp_matches_jax(rows, width, batch):
    """The gather's autograd Function (K8 forward, its CPU backward K11's
    plain version, ``index_add_``) against ``jax.vjp`` of ``t[i]``: the
    table's gradient within 1e-6 relative (sums in another order)."""
    rs = np.random.RandomState(1)
    table = rs.rand(rows, width).astype(np.float32)
    idx = rs.randint(0, rows, batch).astype(np.int32)
    cot = rs.uniform(-1, 1, (batch, width)).astype(np.float32)
    _, vjp = jax.vjp(lambda t: t[jnp.asarray(idx)], jnp.asarray(table))
    ref = np.asarray(vjp(jnp.asarray(cot))[0])
    t = torch.tensor(table, requires_grad=True)
    out = row_gather(t, torch.as_tensor(idx))
    assert out.grad_fn is not None
    out.backward(torch.as_tensor(cot))
    np.testing.assert_allclose(t.grad.numpy(), ref, rtol=1e-6, atol=1e-6)
