"""The port's sequence parallelism (``parallel/sequence.py``): ring
attention and Ulysses against the JAX package's under ``shard_map``, the
flash ring's per-hop backward against JAX's flash kernel on the global
``lse``, the ring's hop (``collectives.ppermute``), the launchers and the
refusals.

Sizes of the JAX tests: 64 positions, head dim 16 (the ring a single
head, as JAX's op takes it, and 2 heads through JAX's ``vmap``; Ulysses 4
heads), inputs from ``np.random.default_rng``. The port's ranks are
threads of a loopback mesh on the CPU (``Mesh(axes, "cpu",
loopback=True)``: the hop and the all-to-alls are the plain ones), and
once 4 gloo processes (``batch_isend_irecv``). JAX runs on the conftest's
fake CPU devices, its Pallas kernels in interpret mode. Tolerance: f32
within rtol 1e-5, atol 1e-5 (the frameworks' CPU products sum in other
orders; both sides are within 1e-6 of float64 here).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from distributed_llm_code_samples_tpu.ops.pallas_attention import (
    flash_attention_bwd as j_flash_bwd)
from distributed_llm_code_samples_tpu.parallel import make_mesh as j_mesh
from distributed_llm_code_samples_tpu.parallel.sequence import (
    ring_attention as j_ring)
from distributed_llm_code_samples_tpu.parallel.sequence import (
    ulysses_attention as j_ulysses)
from distributed_llm_code_samples_tpu.parallel.transformer import (
    resolve_attn as j_resolve_attn)
from distributed_llm_code_samples_tpu_torch.ops import flash_attention as fa
from distributed_llm_code_samples_tpu_torch.parallel import (
    DATA_AXIS, SEQ_AXIS, Mesh, launch, make_mesh, ppermute, resolve_attn,
    resolve_seq_attn, sequence_parallel_attention, ulysses_attention,
    ulysses_parallel_attention)
from distributed_llm_code_samples_tpu_torch.parallel import sequence as seq
from distributed_llm_code_samples_tpu_torch.parallel.launcher import (
    MESH, PerRank, call_each)
from torch_seq_ranks import ring_fwd_bwd

T, DH, H = 64, 16, 4
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _loopback(axes):
    return Mesh(dict(axes), "cpu", loopback=True)


def _blocks(arrays, n, r, dim=-2):
    return [torch.from_numpy(a).chunk(n, dim)[r].contiguous()
            for a in arrays]


def _ring_calls(arrays, n, impl, causal=True):
    """``call_each`` calls of ``torch_seq_ranks.ring_fwd_bwd`` on each
    rank's blocks of ``arrays`` for a mesh of up to 8 ranks whose last
    axis is the seq axis of n ranks (rank r's seq index r % n)."""
    blocks = [_blocks(arrays, n, r % n) for r in range(8)]
    return [(ring_fwd_bwd, (MESH, *(PerRank([b[i] for b in blocks])
                                    for i in range(4))),
             dict(attn_impl=impl, causal=causal))]


def _port_ring(q, k, v, dy, n, causal, impl):
    """The port's ring forward and hand-written backward on n loopback
    threads; the rank blocks joined again: ``(y, lse, dq, dk, dv)``."""
    outs = [o[0] for o in launch(call_each, _loopback({SEQ_AXIS: n}),
                                 _ring_calls((q, k, v, dy), n, impl, causal),
                                 timeout=60)]
    return [torch.cat([o[i] for o in outs], -1 if i == 1 else -2).numpy()
            for i in range(5)]


@functools.lru_cache(maxsize=None)
def _j_ring(n, causal, impl, heads):
    """JAX's ring under ``shard_map`` on n fake devices, forward and
    ``jax.vjp``; ``heads`` vmaps it over a leading dim, as JAX's
    ``resolve_seq_attn`` does."""
    def ring(q, k, v):
        return j_ring(q, k, v, SEQ_AXIS, causal, attn_impl=impl,
                      interpret=impl == "flash")

    spec = P(None, SEQ_AXIS, None) if heads else P(SEQ_AXIS, None)
    f = jax.shard_map(jax.vmap(ring) if heads else ring,
                      mesh=j_mesh({SEQ_AXIS: n}), in_specs=(spec,) * 3,
                      out_specs=spec, check_vma=impl is None)

    @jax.jit
    def run(q, k, v, dy):
        y, vjp = jax.vjp(f, q, k, v)
        return (y, *vjp(dy))
    return run


def _close(got, want, names):
    for g, w, name in zip(got, want, names):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                   err_msg=name, **TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("impl", [None, "flash"])
def test_ring_matches_jax(impl, causal, n):
    """``ring_attention`` forward and its hand-written backward ring ==
    JAX's ``ring_attention`` and ``jax.vjp`` through its custom VJP."""
    q, k, v, dy = _inputs((T, DH), seed=n + 10 * causal)
    y, _, *grads = _port_ring(q, k, v, dy, n, causal, impl)
    want = _j_ring(n, causal, impl, False)(q, k, v, dy)
    _close([y, *grads], want, ["y", "dq", "dk", "dv"])


@pytest.mark.parametrize("impl", [None, "flash"])
def test_ring_takes_leading_dims(impl):
    """One call covers every head: ``[2, T, dh]`` == JAX's ring ``vmap``ped
    over the heads (``resolve_seq_attn``'s form); the ring's ``lse`` is
    the logsumexp of each whole causal row."""
    q, k, v, dy = _inputs((2, T, DH), seed=3)
    y, lse, *grads = _port_ring(q, k, v, dy, 4, True, impl)
    _close([y, *grads], _j_ring(4, True, impl, True)(q, k, v, dy),
           ["y", "dq", "dk", "dv"])
    s = np.einsum("htd,hsd->hts", q, k).astype(np.float64) / np.sqrt(DH)
    s[:, np.triu(np.ones((T, T), bool), 1)] = -np.inf
    m = s.max(-1)
    np.testing.assert_allclose(
        lse, m + np.log(np.exp(s - m[..., None]).sum(-1)), **TOL)


@functools.lru_cache(maxsize=None)
def _j_flash_bwd(causal):
    return jax.jit(lambda *a: j_flash_bwd(*a, causal=causal, interpret=True))


def test_flash_ring_bwd_takes_global_lse(monkeypatch):
    """Each hop's flash backward is handed the ring's GLOBAL ``y`` and
    ``lse`` (those the forward returned), and on those inputs it equals
    JAX's ``flash_attention_bwd`` in interpret mode; the causal ring of 4
    makes rank r's r+1 calls (the later blocks are skipped)."""
    n = 4
    q, k, v, dy = _inputs((T, DH), seed=21)
    calls, bwd = [], fa.flash_attention_bwd

    def recorded(*args, **kw):
        out = bwd(*args, **kw)
        calls.append((args, kw, out))
        return out

    monkeypatch.setattr(fa, "flash_attention_bwd", recorded)

    def body(mesh, _):
        r = mesh.axis_index(SEQ_AXIS)
        qb, kb, vb, dyb = _blocks((q, k, v, dy), n, r)
        y, lse = seq.ring_attention_fwd(qb, kb, vb, mesh, attn_impl="flash")
        seq.ring_attention_bwd(qb, kb, vb, y, lse, dyb, mesh,
                               attn_impl="flash")
        return y, lse

    outs = launch(body, _loopback({SEQ_AXIS: n}), timeout=60)
    assert len(calls) == n * (n + 1) // 2
    assert sum(kw["causal"] for _, kw, _ in calls) == n   # one diagonal each
    for (d_y, q_r, k_j, v_j, y, lse), kw, out in calls:
        r = next(i for i in range(n)
                 if torch.equal(q_r, torch.from_numpy(q).chunk(n, 0)[i]))
        assert torch.equal(y, outs[r][0]) and torch.equal(lse, outs[r][1])
        want = _j_flash_bwd(kw["causal"])(*(t.numpy() for t in (
            d_y, q_r, k_j, v_j, y, lse)))
        _close(out, want, ["dq", "dk", "dv"])


@functools.lru_cache(maxsize=None)
def _j_ulysses(n, causal, attn):
    spec = P(None, SEQ_AXIS, None)
    f = jax.shard_map(
        lambda q, k, v: j_ulysses(q, k, v, SEQ_AXIS, causal,
                                  attn=j_resolve_attn(attn)),
        mesh=j_mesh({SEQ_AXIS: n}), in_specs=(spec,) * 3, out_specs=spec,
        check_vma=attn is None or causal)

    @jax.jit
    def run(q, k, v, dy):
        y, vjp = jax.vjp(f, q, k, v)
        return (y, *vjp(dy))
    return run


@pytest.mark.parametrize("comm", ["psum", "pallas_a2a"])
@pytest.mark.parametrize("attn", [None, "flash"])
@pytest.mark.parametrize("causal", [True, False])
def test_ulysses_matches_jax(causal, attn, comm):
    """``ulysses_attention`` with the hand-VJP ``mha`` and with the flash
    kernels, on either transport, forward and backward
    (``ulysses_attention_fwd``/``_bwd``) == JAX's ``ulysses_attention``
    and ``jax.vjp``; the op-level form equals the forward. The two
    transports only move blocks, so they agree bit for bit."""
    n = 4
    q, k, v, dy = _inputs((H, T, DH), seed=5 + causal)
    op = resolve_attn(attn)

    def body(mesh, _):
        r = mesh.axis_index(SEQ_AXIS)
        qb, kb, vb, dyb = _blocks((q, k, v, dy), n, r)
        y, res = seq.ulysses_attention_fwd(qb, kb, vb, mesh, causal=causal,
                                           attn=op, comm=comm)
        grads = seq.ulysses_attention_bwd(res, dyb, mesh, comm=comm)
        plain = ulysses_attention(qb, kb, vb, mesh, causal=causal, attn=op,
                                  comm="psum")
        return (y, *grads, plain)

    outs = launch(body, _loopback({SEQ_AXIS: n}), timeout=60)
    got = [torch.cat([o[i] for o in outs], -2) for i in range(5)]
    assert torch.equal(got[0], got[4])
    _close(got[:4], _j_ulysses(n, causal, attn)(q, k, v, dy),
           ["y", "dq", "dk", "dv"])


def test_ppermute_and_ring_on_gloo_ranks():
    """The hop on spawned gloo ranks (``batch_isend_irecv``) on a data x
    seq mesh, along each axis (the peers' global ranks within the axis
    group), and the flash ring over the seq axis there == on loopback
    threads."""
    axes = {DATA_AXIS: 2, SEQ_AXIS: 2}
    tag = [torch.full((3,), float(r)) for r in range(4)]
    ring = _ring_calls(_inputs((T, DH), seed=8), 2, "flash")
    calls = [(ppermute, (PerRank(tag), MESH), dict(axis=SEQ_AXIS)),
             (ppermute, (PerRank(tag), MESH), dict(axis=DATA_AXIS))] + ring
    outs = launch(call_each, make_mesh(axes, device="cpu"), calls,
                  timeout=120)
    threads = launch(call_each, _loopback(axes), ring, timeout=60)
    # rank r = (data r // 2, seq r % 2): its seq neighbour is r ^ 1, its
    # data neighbour r ^ 2
    for r, (by_seq, by_data, got) in enumerate(outs):
        assert torch.equal(by_seq, tag[r ^ 1])
        assert torch.equal(by_data, tag[r ^ 2])
        for a, b in zip(got, threads[r][0]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)


@pytest.mark.parametrize("kind", ["ring", "ulysses"])
def test_launchers_match_whole_attention(kind):
    """``sequence_parallel_attention`` / ``ulysses_parallel_attention``
    over a seq mesh of 4 threads == attention over the whole sequence."""
    q, k, v, _ = (torch.from_numpy(a) for a in _inputs((H, T, DH), seed=9))
    fn = (sequence_parallel_attention if kind == "ring"
          else ulysses_parallel_attention)
    got = fn(q, k, v, _loopback({SEQ_AXIS: 4}), causal=True)
    want = fa.flash_attention_fwd_ref(q.double(), k.double(), v.double(),
                                      causal=True)[0]
    torch.testing.assert_close(got.double(), want, **TOL)


def test_refusals():
    """JAX's errors: a sequence or a head count the ranks do not divide,
    an unknown ``seq_impl``, ``comm`` or ring ``attn_impl``; and the
    kernel transport only over a mesh of the seq axis alone."""
    with pytest.raises(ValueError, match="seq_len=66 not divisible"):
        resolve_seq_attn("ring", 4, 4, 66)
    with pytest.raises(ValueError, match="n_heads=6 not divisible"):
        resolve_seq_attn("ulysses", 4, 6, 64)
    with pytest.raises(ValueError, match="unknown seq_impl 'zigzag'"):
        resolve_seq_attn("zigzag", 4, 4, 64)
    with pytest.raises(ValueError, match="unknown attn_impl 'rope'"):
        resolve_seq_attn("ring", 4, 4, 64, attn_impl="rope")
    q = torch.zeros(2, 8, 4)

    def body(mesh, comm):
        return ulysses_attention(q, q, q, mesh, comm=comm)

    for axes, comm, msg in (({SEQ_AXIS: 2}, "nccl", "unknown comm 'nccl'"),
                            ({DATA_AXIS: 2, SEQ_AXIS: 2}, "pallas_a2a",
                             "seq axis alone")):
        with pytest.raises(RuntimeError) as e:
            launch(body, _loopback(axes), comm, timeout=30)
        assert msg in repr(e.value.__cause__)
    q = torch.zeros(2, 6, 4)
    with pytest.raises(ValueError, match="not divisible by 4 seq shards"):
        sequence_parallel_attention(q, q, q, _loopback({SEQ_AXIS: 4}))
