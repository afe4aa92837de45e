"""The port's ``PagePool`` against the reference's: the same sequence of
verbs on both pools leaves byte-identical device pages, host pages and
scale sidecars (bf16 compared through an int16 view), the same free lists
and the same billed bytes, for every tier-format pair."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.kvpool import PagePool as JaxPagePool
from repro_torch.serving.kvpool import PagePool


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Test workers share the CPU: one intra-op thread per process keeps
    torch from oversubscribing it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


GEOMETRY = dict(layers=3, kv_heads=2, head_dim=16, page_tokens=8,
                n_device_pages=10, n_host_pages=8)
FORMATS = [("bf16", "bf16"), ("bf16", "int8"), ("int8", "int8")]


def bits(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy() if x.dtype == torch.bfloat16 else x.numpy()
    a = np.asarray(x)
    return a.view(np.int16) if a.dtype in (np.uint16,) or a.dtype.name == "bfloat16" else a


def assert_same(pool: PagePool, jpool: JaxPagePool) -> None:
    np.testing.assert_array_equal(bits(pool.k), bits(jpool.k))
    np.testing.assert_array_equal(bits(pool.v), bits(jpool.v))
    np.testing.assert_array_equal(bits(pool.host_k), bits(jpool.host_k))
    np.testing.assert_array_equal(bits(pool.host_v), bits(jpool.host_v))
    for a, b in ((pool.k_scale, jpool.k_scale), (pool.v_scale, jpool.v_scale),
                 (pool.host_k_scale, jpool.host_k_scale),
                 (pool.host_v_scale, jpool.host_v_scale)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert pool.stats().__dict__ == jpool.stats().__dict__
    assert pool._free_dev == jpool._free_dev and pool._free_host == jpool._free_host
    assert (pool.page_bytes, pool.host_page_bytes) == (jpool.page_bytes, jpool.host_page_bytes)


@pytest.mark.parametrize("device_format,offload_format", FORMATS)
def test_same_verbs_give_identical_bytes(device_format, offload_format):
    fmts = dict(device_format=device_format, offload_format=offload_format)
    pool = PagePool(device="cpu", **GEOMETRY, **fmts)
    jpool = JaxPagePool(**GEOMETRY, **fmts)
    peer = PagePool(device="cpu", **GEOMETRY, **fmts)
    jpeer = JaxPagePool(**GEOMETRY, **fmts)
    rng = np.random.default_rng(0)
    L, KH, HD = 3, 2, 16

    def run(shape):
        return rng.standard_normal(shape, dtype=np.float32) * 3

    def both(verb, *args):
        """Call ``verb`` on both pools; array args go in as each side's
        bf16 type; returns both results."""
        t = [torch.from_numpy(a).bfloat16() if isinstance(a, np.ndarray) else a for a in args]
        j = [jnp.asarray(a, jnp.bfloat16) if isinstance(a, np.ndarray) else a for a in args]
        return getattr(pool, verb)(*t), getattr(jpool, verb)(*j)

    pages = [pool.alloc_device() for _ in range(4)]
    assert pages == [jpool.alloc_device() for _ in range(4)]
    # a run with a partial tail page, then a one-page rewrite
    both("write_device_pages", pages[:3], run((L, 19, KH, HD)), run((L, 19, KH, HD)))
    both("write_device_pages", pages[3:], run((L, 5, KH, HD)), run((L, 5, KH, HD)))
    got, want = both("read_device_pages", pages)
    np.testing.assert_array_equal(bits(got[0]), bits(want[0]))
    assert_same(pool, jpool)

    hp, jhp = both("offload_page", pages[0])             # copy + free + bill
    assert hp == jhp
    staged, jstaged = both("copy_page_to_host", pages[1])  # copy without free
    assert staged == jstaged
    assert_same(pool, jpool)
    dp, jdp = both("reload_page", hp)                    # back to the device
    assert dp == jdp
    both("copy_page_to_device", staged)
    assert_same(pool, jpool)

    # cross-replica import is format-verbatim
    imp = peer.import_host_page(pool, staged)
    assert imp == jpeer.import_host_page(jpool, staged)
    np.testing.assert_array_equal(bits(peer.host_k[:, imp]), bits(pool.host_k[:, staged]))
    np.testing.assert_array_equal(bits(peer.host_k), bits(jpeer.host_k))
    if offload_format == "int8":
        np.testing.assert_array_equal(peer.host_k_scale.numpy(), np.asarray(jpeer.host_k_scale))


def test_bf16_round_trip_is_bit_exact():
    pool = PagePool(device="cpu", **GEOMETRY)
    page = pool.alloc_device()
    kt = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (3, 8, 2, 16), dtype=np.float32) * 1e4).bfloat16()
    pool.write_device_pages([page], kt, -kt)
    before = pool.k[:, page].clone()
    dp = pool.reload_page(pool.offload_page(page))
    assert torch.equal(pool.k[:, dp].view(torch.int16), before.view(torch.int16))
    assert pool.offload_bytes == pool.reload_bytes == pool.host_page_bytes


def test_int8_device_requires_int8_offload():
    with pytest.raises(ValueError, match="offload_format='int8'"):
        PagePool(device="cpu", **GEOMETRY, device_format="int8")


def test_adopt_takes_only_tensors_like_the_pools_own():
    pool = PagePool(device="cpu", **GEOMETRY, device_format="int8", offload_format="int8")
    k, v = pool.block_table_view()
    ks, vs = pool.scale_view()
    new = [k.clone().fill_(3), v.clone().fill_(-2), ks.clone().fill_(0.5), vs.clone().fill_(2.0)]
    pool.adopt(*new)
    # copied in place: the pool's tensors keep their addresses
    assert pool.k is k and pool.v is v and pool.k_scale is ks and pool.v_scale is vs
    for got, want in zip((k, v, ks, vs), new):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="scale sidecars"):
        pool.adopt(k.clone().fill_(1), v)
    with pytest.raises(ValueError, match="like the pool's own"):
        pool.adopt(k.float(), v, ks, vs)
    # a refused adopt copied nothing
    assert torch.equal(k, new[0])
