"""The port's paged KV pool against the JAX package's ``decode/paged.py``.

After the same sequence of ``write_chunk`` / ``write_rows`` calls (whole
blocks, a partial block, the int8 single-block case, a padded decode
batch) both pools must hold the same bytes: bit for bit at f32 and
bf16; at int8 the codes may differ by at most 1 and the scales by 1e-6
relative (a value at a rounding boundary may land on either side when
the two frameworks' f32 divides differ in the last place). Inputs are
made from a seed with numpy; the port runs on the CPU.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode import paged as jpaged
from distributed_llm_code_samples_tpu_torch.decode import paged as tpaged

L, NB, HKV, BLK, DH = 2, 9, 2, 8, 4


def _ops(seed):
    """A write history: (kind, layer, args, k, v) with numpy payloads."""
    rng = np.random.default_rng(seed)

    def kv(n):
        return (rng.normal(size=(n, HKV, DH)).astype(np.float32) * 2,
                rng.normal(size=(n, HKV, DH)).astype(np.float32))

    table_a = np.array([3, 5, 1, 0, 0], np.int32)
    table_b = np.array([7, 2, 0, 0, 0], np.int32)
    ops = []
    for layer in range(L):
        ops.append(("chunk", layer, (table_a, 0), *kv(16)))    # 2 blocks
        ops.append(("chunk", layer, (table_a, 16), *kv(4)))    # part-fill
        ops.append(("chunk", layer, (table_a, 20), *kv(2)))    # same block
        ops.append(("chunk", layer, (table_b, 0), *kv(8)))     # 1 block
        # a padded decode batch: two live rows and one scratch pad row
        ops.append(("rows", layer,
                    (np.array([1, 2, 0], np.int32),
                     np.array([6, 0, 0], np.int32)), *kv(3)))
        ops.append(("rows", layer,
                    (np.array([1, 2], np.int32),
                     np.array([7, 1], np.int32)), *kv(2)))
    return ops


def _run_both(kv_dtype, seed=0):
    jp = jpaged.init_pool(L, NB, HKV, BLK, DH, kv_dtype)
    tp = tpaged.init_pool(L, NB, HKV, BLK, DH, kv_dtype)
    for kind, layer, args, k, v in _ops(seed):
        if kind == "chunk":
            table, pos0 = args
            jp = jpaged.write_chunk(jp, layer, jnp.asarray(table), pos0,
                                    jnp.asarray(k), jnp.asarray(v),
                                    kv_dtype)
            tp = tpaged.write_chunk(tp, layer, torch.from_numpy(table),
                                    pos0, torch.from_numpy(k),
                                    torch.from_numpy(v), kv_dtype)
        else:
            phys, off = args
            jp = jpaged.write_rows(jp, layer, jnp.asarray(phys),
                                   jnp.asarray(off), jnp.asarray(k),
                                   jnp.asarray(v), kv_dtype)
            tp = tpaged.write_rows(tp, layer, torch.from_numpy(phys),
                                   torch.from_numpy(off),
                                   torch.from_numpy(k),
                                   torch.from_numpy(v), kv_dtype)
    return jp, tp


def _bits(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy()
    return t.numpy().view(np.int32)


def _jbits(a):
    a = np.asarray(a)
    return a.view(np.int16) if a.dtype.itemsize == 2 else a.view(np.int32)


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16"])
def test_writes_bitwise(kv_dtype):
    jp, tp = _run_both(kv_dtype)
    assert tp.k.dtype == tpaged.storage_dtype(kv_dtype)
    np.testing.assert_array_equal(_bits(tp.k), _jbits(jp.k))
    np.testing.assert_array_equal(_bits(tp.v), _jbits(jp.v))
    assert tp.k_scale is None and jp.k_scale is None


@pytest.mark.parametrize("seed", [0, 1])
def test_int8_writes_within_one_code(seed):
    jp, tp = _run_both("int8", seed)
    for t, j in ((tp.k, jp.k), (tp.v, jp.v)):
        d = np.abs(t.numpy().astype(np.int32) - np.asarray(j).astype(
            np.int32))
        assert d.max() <= 1
    for t, j in ((tp.k_scale, jp.k_scale), (tp.v_scale, jp.v_scale)):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=1e-6,
                                   atol=0)
    assert np.asarray(jp.k_scale).max() > 0      # the history did write


@pytest.mark.parametrize("kv_dtype", ["f32", "bf16", "int8"])
def test_gather_layer_matches_jax(kv_dtype):
    jp, tp = _run_both(kv_dtype)
    table = np.array([3, 5, 1, 0, 0], np.int32)
    for layer in range(L):
        got = tpaged.gather_layer(tp, layer, torch.from_numpy(table))
        want = jpaged.gather_layer(jp, layer, jnp.asarray(table))
        for g, w in zip(got, want):
            assert g.dtype == torch.float32
            # int8: one code step of the block's scale at most
            atol = 1e-6 if kv_dtype != "int8" else float(
                np.asarray(jp.k_scale).max() + np.asarray(jp.v_scale).max())
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=atol)


def test_quantize_matches_jax_round_half_even():
    """Values at exact .5 code boundaries round to even on both sides."""
    x = np.zeros((1, 2, 4), np.float32)
    x[0, 0] = [127.0, 0.5, 1.5, -2.5]             # scale 1: codes exact
    x[0, 1] = [-3.5, 4.5, 126.5, 0.0]
    valid = np.array([[True, True]])
    tq, ts = tpaged._quantize(torch.from_numpy(x), torch.from_numpy(valid))
    jq, js = jpaged._quantize(jnp.asarray(x), jnp.asarray(valid))
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq.numpy()[0, 0].tolist() == [127, 0, 2, -2]


def test_scrub_and_pool_shapes():
    tp = tpaged.init_pool(L, NB, HKV, BLK, DH, "int8")
    assert tuple(tp.k.shape) == (L, NB, HKV, BLK, DH)
    assert tuple(tp.k_scale.shape) == (L, NB, HKV)
    tp.k.fill_(3)
    tp.k_scale.fill_(float("nan"))
    tpaged.scrub_blocks(tp, [0, 4])
    assert int(tp.k[:, [0, 4]].abs().sum()) == 0
    assert float(tp.k_scale[:, [0, 4]].abs().sum()) == 0.0
    assert torch.isnan(tp.k_scale[:, 1]).all()
    assert tpaged.kv_bytes_per_token("int8", 12, 12, 64) == \
        jpaged.kv_bytes_per_token("int8", 12, 12, 64)
    with pytest.raises(ValueError):
        tpaged.init_pool(L, 1, HKV, BLK, DH)
