"""The port's all-to-all (``ops/ring.py``: ``all_to_all_dma``, its
tiled, differentiable form ``all_to_all_dma_dims``, and
``parallel/collectives.py::all_to_all``) against the JAX package's
Pallas ``all_to_all_dma`` and ``all_to_all_dma_dims``.

On the CPU the port's wrapper runs its plain version: n-1 ``isend`` /
``irecv`` pairs on ``torch.distributed``, here on four gloo ranks (one
spawn for every case). JAX runs its kernel in the Mosaic TPU interpreter
on the conftest ``mesh4``, as ``tests/test_pallas_ring.py`` does. Every
rank gets the same numpy block as the JAX device of its index.

Tolerance: none. The exchange moves chunks and adds nothing, so every
result, forward and backward, is equal bit for bit. The bf16 cases
(``--dtype bfloat16``'s EP) move the bits of bf16 blocks, EP's dispatch
operand and one whose chunk holds an odd element count (the kernel
moves it through a copy padded by one element a chunk).
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
from distributed_llm_code_samples_tpu_torch.parallel import (
    all_to_all, launch, make_mesh)
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, PerRank, call_each)

N = 4
# (case, per-rank block shape): the dim-0 exchange of a 2-D block, a 3-D
# one, and EP's dispatch operand [E, C, d] at test size
CASES = [("2d", (8, 32)), ("3d", (8, 3, 5)), ("ep", (8, 6, 16)),
         ("ep_bf16", (8, 6, 16)), ("odd_bf16", (4, 3, 5))]
# (split_dim, concat_dim, per-rank input shape): EP's dispatch and its
# return ([E/n, n*C, d] back to [E, C, d])
DIMS = [(0, 1, (8, 6, 16)), (1, 0, (2, 24, 16))]


def _blocks(case, shape):
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    out = rng.normal(size=(N,) + shape).astype(np.float32)
    if case.endswith("_bf16"):    # bf16 values, widened exactly
        out = np.asarray(jnp.asarray(out, jnp.bfloat16)).astype(np.float32)
    return out


def _as_port(case, block):
    t = torch.from_numpy(block)
    return t.bfloat16() if case.endswith("_bf16") else t


def _as_jax(case, blocks):
    return jnp.asarray(blocks, jnp.bfloat16) if case.endswith("_bf16") \
        else blocks


def _np(t):
    """A port output as f32 numpy (bf16 widened exactly)."""
    assert t.dtype in (torch.float32, torch.bfloat16)
    return t.float().numpy()


def _identifying():
    # block j of rank r carries 10 r + j; after the exchange rank r must
    # hold 10 j + r at position j (test_pallas_ring.py:288)
    return np.stack([np.repeat((10.0 * r + np.arange(N))[:, None], 8, 1)
                     for r in range(N)]).astype(np.float32)


def _sm(mesh4, fn, *blocks):
    f = jax.shard_map(fn, mesh=mesh4,
                      in_specs=tuple(P(DATA_AXIS) for _ in blocks),
                      out_specs=P(DATA_AXIS), check_vma=False)
    out = f(*(b.reshape((-1,) + b.shape[2:]) for b in blocks))
    return np.asarray(out).reshape((N, -1) + np.asarray(out).shape[1:])


def _jax_a2a(mesh4, blocks):
    return _sm(mesh4, functools.partial(jr.all_to_all_dma,
                                        axis_name=DATA_AXIS,
                                        interpret=True), blocks)


def _jax_dims(mesh4, x, dy, split_dim, concat_dim):
    """JAX's tiled kernel exchange and its VJP on ``dy``."""
    def fwd(v):
        return jr.all_to_all_dma_dims(v, DATA_AXIS, split_dim, concat_dim,
                                      True)

    def body(v, g):
        y, vjp = jax.vjp(fwd, v)
        return y, vjp(g)[0]

    f = jax.shard_map(body, mesh=mesh4, in_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                      out_specs=(P(DATA_AXIS), P(DATA_AXIS)),
                      check_vma=False)
    y, dx = f(x.reshape((-1,) + x.shape[2:]), dy.reshape((-1,) + dy.shape[2:]))
    y, dx = np.asarray(y), np.asarray(dx)
    return (y.reshape((N, -1) + y.shape[1:]),
            dx.reshape((N, -1) + dx.shape[1:]))


def dims_with_grad(x, dy, mesh, split_dim, concat_dim):
    """On a rank: the port's ``all_to_all_dma_dims`` forward and its
    autograd backward on ``dy``."""
    x = x.clone().requires_grad_()
    y = ring.all_to_all_dma_dims(x, mesh, split_dim, concat_dim)
    dx, = torch.autograd.grad(y, x, dy)
    return y.detach(), dx


@pytest.fixture(scope="module")
def port_results():
    """Every case through the port on 4 gloo ranks, one spawn:
    ``{case: [rank 0's output, ...]}``."""
    inputs = {case: _blocks(case, shape) for case, shape in CASES}
    inputs["identifying"] = _identifying()
    calls = [(ring.all_to_all_dma,
              (PerRank([_as_port(c, b) for b in inputs[c]]), MESH), {})
             for c in inputs]
    calls += [(all_to_all, (PerRank([_as_port(c, b)
                                     for b in inputs[c]]), MESH),
               dict(split_dim=0, concat_dim=0)) for c in inputs]
    dims = {}
    for sd, cd, shape in DIMS:
        x = _blocks(f"x{sd}{cd}", shape)
        y_shape = list(shape)
        y_shape[sd] //= N
        y_shape[cd] *= N
        dy = _blocks(f"dy{sd}{cd}", tuple(y_shape))
        dims[sd, cd] = (x, dy)
        calls.append((dims_with_grad, (PerRank(map(torch.from_numpy, x)),
                                       PerRank(map(torch.from_numpy, dy)),
                                       MESH, sd, cd), {}))
        calls.append((all_to_all, (PerRank(map(torch.from_numpy, x)), MESH),
                      dict(split_dim=sd, concat_dim=cd)))
    outs = launch(call_each, make_mesh({"expert": N}, device="cpu"), calls,
                  timeout=180)
    per = [[outs[r][i] for r in range(N)] for i in range(len(calls))]
    m = len(inputs)
    return dict(inputs=inputs, dims=dims,
                kernel={c: per[i] for i, c in enumerate(inputs)},
                psum={c: per[m + i] for i, c in enumerate(inputs)},
                dims_out={key: (per[2 * m + 2 * i], per[2 * m + 2 * i + 1])
                          for i, key in enumerate(dims)})


@pytest.mark.parametrize("case", [c for c, _ in CASES] + ["identifying"])
def test_plain_a2a_equals_pallas_a2a(mesh4, port_results, case):
    blocks = port_results["inputs"][case]
    want = _jax_a2a(mesh4, _as_jax(case, blocks)).astype(np.float32)
    for r in range(N):
        out = port_results["kernel"][case][r]
        assert out.dtype == (torch.bfloat16 if case.endswith("_bf16")
                             else torch.float32)
        got = _np(out)
        assert got.shape == want[r].shape
        np.testing.assert_array_equal(got, want[r])
        # torch.distributed's all_to_all_single gives the same
        np.testing.assert_array_equal(_np(port_results["psum"][case][r]),
                                      want[r])
    if case == "identifying":
        for r in range(N):
            assert (want[r][:, 0] == 10 * np.arange(N) + r).all()


@pytest.mark.parametrize("split_dim,concat_dim",
                         [(sd, cd) for sd, cd, _ in DIMS])
def test_a2a_dims_forward_and_backward_equal_jax_vjp(mesh4, port_results,
                                                     split_dim, concat_dim):
    x, dy = port_results["dims"][split_dim, concat_dim]
    want_y, want_dx = _jax_dims(mesh4, x, dy, split_dim, concat_dim)
    fwd_bwd, psum = port_results["dims_out"][split_dim, concat_dim]
    for r in range(N):
        y, dx = fwd_bwd[r]
        np.testing.assert_array_equal(y.numpy(), want_y[r])
        np.testing.assert_array_equal(dx.numpy(), want_dx[r])
        np.testing.assert_array_equal(psum[r].numpy(), want_y[r])


def test_indivisible_leading_dim_raises_on_both_sides(mesh4):
    blocks = np.ones((N, 9, 8), np.float32)    # 9 rows do not split 4 ways
    with pytest.raises(ValueError, match="not divisible by 4 peers"):
        _jax_a2a(mesh4, blocks)
    # the port checks before any rank communicates
    with pytest.raises(ValueError, match="not divisible by 4 peers"):
        ring.all_to_all_dma(torch.ones(9, 8), ring.Ring(N, 0))
    with pytest.raises(ValueError, match="not divisible by 4 peers"):
        ring.loopback_ref(ring.ALL_TO_ALL, [torch.ones(9, 8)] * N)


def test_loopback_ref_is_the_exchange(port_results):
    """The one-process plain version that holds the kernel in loopback
    gives the gloo ranks' results bit for bit."""
    for case, blocks in port_results["inputs"].items():
        want = ring.loopback_ref(ring.ALL_TO_ALL,
                                 [_as_port(case, b) for b in blocks])
        for r in range(N):
            assert torch.equal(port_results["kernel"][case][r], want[r])
