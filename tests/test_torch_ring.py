"""The port's ring collectives (``ops/ring.py``) against the JAX
package's Pallas ring kernels (``ops/pallas_ring.py``).

On the CPU each wrapper runs its plain version: the same ring, with the
same chunks and the same summation order, on ``torch.distributed``
point-to-point. Here it runs on four gloo ranks (one spawn for every
case), and JAX runs its kernels in the Mosaic TPU interpreter on the
conftest ``mesh4``, as ``tests/test_pallas_ring.py`` does. Every rank
gets the same numpy block as the JAX device of its index.

Tolerance: none. The hop and the gather are copies, and each sum adds
the same f32 pairs in the same ring order on both sides (rank r adds its
own chunk ``(r - s - 1) % n`` to the partial that arrived at step s), so
the results are equal bit for bit. The bf16 cases (``--dtype bfloat16``)
add bf16 pairs in that order, each partial sum rounded to bf16 on both
sides (the Pallas kernels add on bf16 refs): bit for bit as well; the
bf16 hop moves the bits, also of an odd element count.
"""

import functools
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_code_samples_tpu.ops import pallas_ring as jr
from distributed_llm_code_samples_tpu.parallel import DATA_AXIS
from distributed_llm_code_samples_tpu_torch.ops import ring
from distributed_llm_code_samples_tpu_torch.parallel import launch, make_mesh
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, PerRank, call_each)

N = 4
# (case, op, per-rank block shape)
CASES = [
    ("hop", "ppermute_dma", (3, 16)),
    ("all_reduce", "ring_all_reduce", (16, 32)),
    ("all_reduce_3d", "ring_all_reduce", (8, 4, 8)),
    ("reduce_scatter", "ring_reduce_scatter", (16, 32)),
    ("reduce_scatter_3d", "ring_reduce_scatter", (8, 4, 6)),
    ("all_gather", "ring_all_gather", (4, 32)),
    ("all_gather_3d", "ring_all_gather", (2, 3, 5)),
]
# the same ops on bf16 blocks: the sums round every add (an even element
# count a chunk), the gather and the hop move the bits (the hop also an
# odd element count, which the kernel moves through a padded copy)
BF16_CASES = [
    ("all_reduce_bf16", "ring_all_reduce", (16, 32)),
    ("all_reduce_3d_bf16", "ring_all_reduce", (8, 4, 8)),
    ("reduce_scatter_bf16", "ring_reduce_scatter", (16, 32)),
    ("reduce_scatter_3d_bf16", "ring_reduce_scatter", (8, 4, 6)),
    ("all_gather_bf16", "ring_all_gather", (4, 32)),
    ("hop_bf16", "ppermute_dma", (3, 16)),
    ("hop_odd_bf16", "ppermute_dma", (3, 5)),
]


def _blocks(case, shape):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    out = rng.normal(size=(N,) + shape).astype(np.float32)
    if case.endswith("_bf16"):    # bf16 values, widened exactly
        out = np.asarray(jnp.asarray(out, jnp.bfloat16)).astype(np.float32)
    return out


def _as_port(case, block):
    t = torch.from_numpy(block)
    return t.bfloat16() if case.endswith("_bf16") else t


def _bits(case, a):
    """An output's bits: the f32 values, or the bf16 words as int16."""
    if not case.endswith("_bf16"):
        return np.asarray(a)
    if isinstance(a, torch.Tensor):
        return a.view(torch.int16).numpy()
    return np.asarray(a).view(np.int16)


def _identifying():
    # rank r contributes 10^r everywhere: a lost or doubled hop shows as
    # a wrong digit (test_pallas_ring.py:88)
    return np.stack([np.full((N, 8), 10.0 ** r, np.float32)
                     for r in range(N)])


def _jax(mesh4, op, blocks):
    fn = functools.partial(getattr(jr, op), axis_name=DATA_AXIS,
                           interpret=True)
    f = jax.shard_map(fn, mesh=mesh4, in_specs=P(DATA_AXIS),
                      out_specs=P(DATA_AXIS), check_vma=False)
    out = np.asarray(f(jnp.asarray(blocks.reshape((-1,) + blocks.shape[2:]))))
    return out.reshape((N, -1) + out.shape[1:])


@pytest.fixture(scope="module")
def port_results():
    """Every case through the port's wrappers on 4 gloo ranks, one
    spawn: ``{case: [rank 0's output, ...]}``."""
    inputs = {case: _blocks(case, shape) for case, _, shape in CASES}
    inputs["identifying"] = _identifying()
    inputs.update((case, _blocks(case, shape))
                  for case, _, shape in BF16_CASES)
    ops = {case: op for case, op, _ in CASES + BF16_CASES}
    ops["identifying"] = "ring_all_reduce"
    calls = [(getattr(ring, ops[c]),
              (PerRank([_as_port(c, b) for b in inputs[c]]), MESH), {})
             for c in inputs]
    outs = launch(call_each, make_mesh({"data": N}, device="cpu"), calls,
                  timeout=180)
    return inputs, ops, {c: [_bits(c, outs[r][i]) for r in range(N)]
                         for i, c in enumerate(inputs)}


@pytest.mark.parametrize("case", [c for c, _, _ in CASES] + ["identifying"]
                         + [c for c, _, _ in BF16_CASES])
def test_plain_ring_equals_pallas_ring(mesh4, port_results, case):
    inputs, ops, results = port_results
    got = results[case]
    blocks = inputs[case]
    if case.endswith("_bf16"):
        blocks = jnp.asarray(blocks, jnp.bfloat16)
    want = _bits(case, _jax(mesh4, ops[case], blocks))
    for r in range(N):
        assert got[r].shape == want[r].shape
        np.testing.assert_array_equal(got[r], want[r])
    if case == "identifying":
        assert (want == 1111.0).all()


@pytest.mark.parametrize("op", ["ring_all_reduce", "ring_reduce_scatter"])
def test_indivisible_leading_dim_raises_on_both_sides(mesh4, op):
    blocks = np.ones((N, 9, 8), np.float32)    # 9 rows do not split 4 ways
    with pytest.raises(ValueError, match="not divisible by ring"):
        _jax(mesh4, op, blocks)
    # the port checks before any rank communicates
    with pytest.raises(ValueError, match="not divisible by ring"):
        getattr(ring, op)(torch.ones(9, 8), ring.Ring(N, 0))


def test_loopback_ref_is_the_ring_order(port_results):
    """The one-process plain version that holds the kernels in loopback
    gives the gloo ring's results bit for bit."""
    inputs, ops, results = port_results
    for case, blocks in inputs.items():
        want = ring.loopback_ref(ops[case],
                                 [_as_port(case, b) for b in blocks])
        for r in range(N):
            np.testing.assert_array_equal(results[case][r],
                                          _bits(case, want[r]))


@pytest.mark.parametrize("case", ["all_reduce_bf16",
                                  "reduce_scatter_bf16"])
def test_bf16_ring_rounds_every_add(port_results, case):
    """The control: the bf16 sums in f32, rounded once, differ from the
    ring's in some elements, so the bit-for-bit checks above tell a ring
    that rounds every add from one that does not."""
    inputs, ops, results = port_results
    once = torch.from_numpy(inputs[case].sum(0)).bfloat16()
    if ops[case] == "ring_reduce_scatter":
        once = once.chunk(N)
    else:
        once = [once] * N
    assert any((results[case][r] != once[r].view(torch.int16).numpy()).any()
               for r in range(N))
