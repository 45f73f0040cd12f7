"""The port's paged decode attention (``ops/paged_attention.py``) against
the JAX package.

On the CPU the wrapper runs its plain version, which is held against the
JAX gather + ``decode_attn`` oracle and against the JAX Pallas kernel in
interpret mode (where this jax supports it, as
``tests/test_pallas_paged_attention.py`` gates it). f32, bf16 and int8
pools; GQA and MHA; ragged lengths including 1, a block boundary and the
full table. Tolerance: atol 1e-6 (sums in other orders; not bitwise).

``test_cuda_kernel_matches_plain`` runs the CUDA kernel itself; it needs
the card and skips without one.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from distributed_llm_code_samples_tpu.decode import init_pool as j_init_pool
from distributed_llm_code_samples_tpu.decode.paged import (
    _quantize as j_quantize, gather_layer as j_gather_layer)
from distributed_llm_code_samples_tpu.models.lm import decode_attn as j_decode
from distributed_llm_code_samples_tpu.ops.pallas_paged_attention import (
    interpret_supported, paged_decode_attn as j_paged)
from distributed_llm_code_samples_tpu_torch.ops import _build
from distributed_llm_code_samples_tpu_torch.ops.paged_attention import (
    paged_decode_attn, paged_decode_attn_ref, smem_bytes, split_plan)

ATOL = 1e-6
BLK, DH, MB = 8, 8, 4
CASES = [(kv, hq, hkv) for kv in ("f32", "bf16", "int8")
         for hq, hkv in ((4, 2), (4, 4), (4, 1))]


def _case(kv_dtype, hq, hkv, seed=0):
    """Numpy inputs: a one-layer pool with random blocks 1.. (block 0 the
    zero scratch block), out-of-order tables with scratch tails, ragged
    lengths (1, a block boundary, one past it, the whole table)."""
    rng = np.random.default_rng(seed)
    nb = 1 + 4 * MB
    src_k = rng.normal(size=(nb, hkv, BLK, DH)).astype(np.float32)
    src_v = rng.normal(size=(nb, hkv, BLK, DH)).astype(np.float32)
    src_k[0] = src_v[0] = 0.0
    pool = j_init_pool(1, nb, hkv, BLK, DH, kv_dtype)
    if kv_dtype == "int8":
        valid = jnp.ones((nb, hkv, BLK), bool)
        qk, ks = j_quantize(jnp.asarray(src_k), valid)
        qv, vs = j_quantize(jnp.asarray(src_v), valid)
        pool = pool._replace(k=qk[None], v=qv[None], k_scale=ks[None],
                             v_scale=vs[None])
    else:
        pool = pool._replace(k=jnp.asarray(src_k, pool.k.dtype)[None],
                             v=jnp.asarray(src_v, pool.v.dtype)[None])
    lengths = np.array([1, BLK, BLK + 1, MB * BLK], np.int32)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((4, MB), np.int32)
    for i, n in enumerate(lengths):
        used = -(-int(n) // BLK)
        tables[i, :used] = perm[i * MB:i * MB + used]
    q = rng.normal(size=(4, hq, DH)).astype(np.float32)
    return pool, q, tables, lengths


def _torch_args(pool, q, tables, lengths):
    def t(a):
        a = np.asarray(a)
        if a.dtype.name == "bfloat16":
            return torch.from_numpy(np.array(a.view(np.int16))).view(
                torch.bfloat16)
        return torch.from_numpy(np.array(a))

    ks = None if pool.k_scale is None else t(pool.k_scale[0])
    vs = None if pool.v_scale is None else t(pool.v_scale[0])
    return (t(q), t(pool.k[0]), t(pool.v[0]), ks, vs, t(tables),
            t(lengths))


@pytest.mark.parametrize("kv_dtype,hq,hkv", CASES)
def test_plain_matches_jax_gather_oracle(kv_dtype, hq, hkv):
    pool, q, tables, lengths = _case(kv_dtype, hq, hkv)
    ck, cv = jax.vmap(lambda t: j_gather_layer(pool, 0, t))(
        jnp.asarray(tables))
    want = np.asarray(j_decode(jnp.asarray(q), ck, cv, jnp.asarray(lengths)))
    args = _torch_args(pool, q, tables, lengths)
    before = _build.launch_counts()
    got = paged_decode_attn(*args)          # CPU tensors: the plain version
    assert _build.launch_counts() == before     # no kernel launched
    assert got.dtype == torch.float32 and tuple(got.shape) == q.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(got.numpy(),
                                  paged_decode_attn_ref(*args).numpy())


@pytest.mark.parametrize("kv_dtype,hq,hkv", CASES)
def test_plain_matches_jax_pallas_interpret(kv_dtype, hq, hkv):
    if not interpret_supported():
        pytest.skip("no scalar-prefetch pallas surface for interpret mode")
    pool, q, tables, lengths = _case(kv_dtype, hq, hkv, seed=1)
    ks = None if pool.k_scale is None else pool.k_scale[0]
    vs = None if pool.v_scale is None else pool.v_scale[0]
    want = np.asarray(j_paged(jnp.asarray(q), pool.k[0], pool.v[0], ks, vs,
                              jnp.asarray(tables), jnp.asarray(lengths),
                              interpret=True))
    got = paged_decode_attn(*_torch_args(pool, q, tables, lengths))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=ATOL)


def test_wrapper_rejects_bad_operands():
    pool, q, tables, lengths = _case("int8", 4, 2)
    args = list(_torch_args(pool, q, tables, lengths))
    with pytest.raises(ValueError, match="both"):
        paged_decode_attn(*args[:3], args[3], None, *args[5:])
    f32 = list(_torch_args(*_case("f32", 4, 2)))
    with pytest.raises(ValueError, match="int8"):
        paged_decode_attn(*f32[:3], args[3], args[4], *f32[5:])
    with pytest.raises(ValueError, match="divisible"):
        paged_decode_attn(args[0][:, :3], *args[1:])
    meta = [None if a is None else a.to("meta") for a in args]
    with pytest.raises(ValueError, match="cpu or cuda"):
        paged_decode_attn(*meta)


def test_shared_memory_budget():
    """A block's shared memory is its split's (``split_plan``), not the
    table's: the serving shape and a table of 8192 positions with 8 query
    rows of 128 (past the old [G, tcap] score row's budget) both fit, and
    a paged block too large for any split is refused by the wrapper
    rather than truncated."""
    pos, splits, _, smem, _ = split_plan(8, 12, 12, 64, 16, 64)
    assert smem == smem_bytes(1, 64, pos, 16, splits) == 4 * (
        2 * 64 * 64 + 64 + 64 + 2 + 2 * 16 + 1 + 3 * 4 + 1)
    assert split_plan(4, 64, 8, 128, 16, 512)[3] < 232448
    assert smem_bytes(1, 2048, 16, 16, 1) > 232448
    with pytest.raises(ValueError, match="shared memory"):
        split_plan(1, 1, 1, 2048, 16, 4)


@pytest.mark.cuda
def test_cuda_kernel_matches_plain():
    """The CUDA kernel against its plain version on the card, at every
    storage dtype, GQA and MHA (needs nvcc and a Hopper card)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    for kv_dtype, hq, hkv in CASES:
        args = [None if a is None else a.cuda()
                for a in _torch_args(*_case(kv_dtype, hq, hkv))]
        before = _build.launch_counts().get("paged_decode_attn", 0)
        got = paged_decode_attn(*args)
        torch.cuda.synchronize()
        assert _build.launch_counts()["paged_decode_attn"] == before + 1
        want = paged_decode_attn_ref(*args)
        err = float((got - want).abs().max())
        assert err <= 2e-5 * float(want.abs().max())
