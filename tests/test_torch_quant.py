"""Port vs reference: the int8 wire codec (``core/quant.py``) on the CPU.

The host half is a numpy copy of the reference's, so on the same input its
codes and scale tables must be EQUAL, not close; the device half (the torch
``dequant_rows``, the plain form of kernel B3's tile load) agrees with the
reference's ``dequant_rows`` to one rounding (x = q * s + z may or may not
be fused into one FMA)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as jq
from repro_torch.core import quant as tq


def _rows(n, p, seed, shift=0.0):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(n, p)) * 3.0 + shift).astype(np.float32)


CASES = [(64, 9, 32), (70, 33, 32), (1, 5, 32), (33, 4, 7), (100, 17, 1),
         (257, 12, 64)]


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n,p,group", CASES)
def test_codes_and_tables_equal_the_reference(n, p, group, symmetric):
    x = _rows(n, p, seed=n + p + group, shift=1.5)
    x[: min(group, n)] = 0.25            # a constant first group
    v, s = tq.quantize_rows(x, group, symmetric=symmetric)
    rv, rs = jq.quantize_rows(x, group, symmetric=symmetric)
    assert v.dtype == np.int8 and s.dtype == np.float32
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(s, rs)
    np.testing.assert_array_equal(tq.group_scales(x, group, symmetric=symmetric),
                                  jq.group_scales(x, group, symmetric=symmetric))
    np.testing.assert_array_equal(tq.expand_scales(s, group, n),
                                  jq.expand_scales(rs, group, n))
    np.testing.assert_array_equal(tq.dequantize_rows(v, s, group),
                                  jq.dequantize_rows(rv, rs, group))
    assert tq.max_quant_error(s) == jq.max_quant_error(rs)
    assert tq.quant_bytes(n, p, group) == jq.quant_bytes(n, p, group)
    assert tq.quant_scale_bytes(n, group) == jq.quant_scale_bytes(n, group)
    assert tq.n_groups(n, group) == jq.n_groups(n, group)
    block, ref_block = tq.QuantBlock(v, s, group), jq.QuantBlock(rv, rs, group)
    assert (block.nbytes, block.scale_bytes, block.shape) == \
        (ref_block.nbytes, ref_block.scale_bytes, ref_block.shape)
    assert block.nbytes == tq.quant_bytes(n, p, group)


@pytest.mark.parametrize("symmetric", [False, True])
def test_constant_groups_and_zero_rows(symmetric):
    """Constant groups and zero rows give the reference's codes and tables;
    under the affine codec a constant group quantises exactly (scale 1,
    codes 0, the midpoint comes back)."""
    x = np.full((40, 6), -2.5, np.float32)
    v, s = tq.quantize_rows(x, 32, symmetric=symmetric)
    rv, rs = jq.quantize_rows(x, 32, symmetric=symmetric)
    np.testing.assert_array_equal(v, rv)
    np.testing.assert_array_equal(s, rs)
    if not symmetric:
        np.testing.assert_array_equal(s[:, 0], 1.0)
        assert not v.any()
        np.testing.assert_array_equal(tq.dequantize_rows(v, s, 32), x)
    for mod in (tq, jq):
        v0, s0 = mod.quantize_rows(np.zeros((0, 6), np.float32), 32,
                                   symmetric=symmetric)
        assert v0.shape == (0, 6) and s0.shape == (0, 2)
    assert tq.max_quant_error(np.zeros((0, 2), np.float32)) == 0.0


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("n,p,group", CASES)
def test_device_dequant_matches_the_reference(n, p, group, symmetric):
    """torch ``dequant_rows`` against the reference's jnp ``dequant_rows``:
    q * s + z fused into one FMA on one side and not on the other differ by
    at most one rounding of the product and one of the sum."""
    x = _rows(n, p, seed=7 * n + p)
    v, s = tq.quantize_rows(x, group, symmetric=symmetric)
    got = tq.dequant_rows(torch.from_numpy(v), torch.from_numpy(s), group).numpy()
    want = np.asarray(jq.dequant_rows(jnp.asarray(v), jnp.asarray(s), group))
    prod = v.astype(np.float32) * tq.expand_scales(s, group, n)[:, :1]
    bound = np.spacing(np.abs(prod)) + np.spacing(np.abs(want))
    assert np.all(np.abs(got - want) <= bound)
    # and the round trip keeps the codec's promise
    assert np.abs(got - x).max() <= tq.max_quant_error(s) * (1 + 1e-5)


def test_encode_rows_under_a_per_row_table_equals_the_reference():
    x = _rows(50, 8, seed=3)
    s = tq.expand_scales(tq.group_scales(x, 16), 16, 50)
    np.testing.assert_array_equal(tq.encode_rows(x, s), jq.encode_rows(x, s))
