"""Int8 page quantization of the PyTorch port against the JAX reference.

Bitwise: the port divides ``x / scale`` in f32 and rounds half to even,
as ``quantize_np`` and the jnp ``quantize_pages`` do, so all three give
identical payloads and scales. The requantizing append matches the
reference's payload exactly and its scales to the last f32 bit. Byte
counts are integers and equal.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import kv_quant as jkvq
from repro_torch.kernels import kv_quant as tkvq


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pages(seed, shape, scale=1.0):
    return np.random.default_rng(seed).standard_normal(shape, dtype=np.float32) * scale


@pytest.mark.parametrize("source_dtype", ["float32", "bfloat16"])
def test_quantize_equals_numpy_and_jnp_bitwise(source_dtype):
    x = pages(0, (3, 5, 8, 2, 16))
    # a page of zeros and a page with an exact .5 quotient exercise the
    # scale floor and the half-to-even rounding
    x[0, 0] = 0.0
    x[1, 2, 0, 0, :2] = [127.0, 0.5]
    if source_dtype == "bfloat16":
        tx = torch.from_numpy(x).to(torch.bfloat16)
        xj = jnp.asarray(x, jnp.bfloat16)
        xf = tx.float().numpy()
    else:
        tx, xj, xf = torch.from_numpy(x), jnp.asarray(x), x
    tq, ts = tkvq.quantize_pages(tx)
    jq, js = jkvq.quantize_pages(xj)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    for layer in range(3):
        nq, ns = jkvq.quantize_np(xf[layer])
        np.testing.assert_array_equal(tq[layer].numpy(), nq)
        np.testing.assert_array_equal(ts[layer].numpy(), ns)
    np.testing.assert_array_equal(
        tkvq.dequantize_pages(tq, ts, torch.float32).numpy(),
        np.asarray(jkvq.dequantize_pages(jq, js, jnp.float32)),
    )


def test_requantize_insert_run_matches_reference():
    L, N, T, KH, HD, B = 3, 6, 8, 2, 16, 3
    x = pages(1, (L, N, T, KH, HD), 0.1)
    new = pages(2, (L, B, KH, HD), 4.0)          # grows some pages' scales
    pg = np.asarray([4, 0, 2], np.int32)
    off = np.asarray([7, 0, 3], np.int32)
    jq, js = jkvq.quantize_pages(jnp.asarray(x))
    jq2, js2 = jkvq.requantize_insert_run(jq, js, jnp.asarray(pg), jnp.asarray(off),
                                          jnp.asarray(new))
    tq, ts = tkvq.quantize_pages(torch.from_numpy(x))
    tkvq.requantize_insert_run(tq, ts, torch.from_numpy(pg).long(),
                               torch.from_numpy(off).long(), torch.from_numpy(new))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js2))
    assert (ts[:, pg].numpy() > np.asarray(js)[:, pg]).all()


def test_requantize_insert_one_layer_matches_reference():
    x = pages(3, (5, 8, 2, 16))
    new = pages(4, (2, 2, 16), 3.0)
    pg, off = np.asarray([3, 1], np.int32), np.asarray([5, 2], np.int32)
    jq, js = jkvq.quantize_pages(jnp.asarray(x))
    jq2, js2 = jkvq.requantize_insert(jq, js, jnp.asarray(pg), jnp.asarray(off),
                                      jnp.asarray(new))
    tq, ts = tkvq.quantize_pages(torch.from_numpy(x))
    tkvq.requantize_insert(tq, ts, torch.from_numpy(pg).long(),
                           torch.from_numpy(off).long(), torch.from_numpy(new))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq2))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js2))


@pytest.mark.parametrize("fmt", ["bf16", "int8"])
@pytest.mark.parametrize("geometry", [(4, 8, 2, 16), (24, 16, 16, 64)])
def test_byte_counts_equal_reference(fmt, geometry):
    L, T, KH, HD = geometry
    assert tkvq.page_wire_bytes(L, T, KH, HD, fmt) == jkvq.page_wire_bytes(L, T, KH, HD, fmt)
    assert tkvq.token_wire_bytes(L, KH, HD, fmt) == jkvq.token_wire_bytes(L, KH, HD, fmt)
    assert tkvq.bytes_per_element(fmt) == jkvq.bytes_per_element(fmt)


def test_unknown_format_rejected():
    with pytest.raises(ValueError, match="unknown KV page format"):
        tkvq.check_format("fp8")
